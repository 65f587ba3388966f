"""Flagship benchmark: 1e6-pixel hyperspectral PGM-NMF on a GPU vs NumPy.

Three measurements:

1. **Unweighted per-iteration marginal** (headline, printed last): the
   full PGM-NMF update (residual, both factor gradients, Lipschitz step
   sizes, non-negativity prox, fixed-point norms — the reference's
   per-iteration work, reference ``nmf.py:39-41,44-65``) vs an
   equivalent NumPy implementation. Marginal slope between two
   iteration counts of one compiled executable cancels per-call
   dispatch overhead.
2. **Weighted flagship** with ``step_stride=10``: the weighted
   Lipschitz bounds (reference ``nmf.py:69-88``) via implicit batched
   power iteration, strided; the NumPy side gets the SAME strided
   implicit algorithm (not the reference's per-iteration sparse eigs,
   which would inflate the win by orders of magnitude).
3. **End-to-end fixed-work solve**: one compiled nmf() call running
   2000 iterations, wall-clock including fixed dispatch overhead; NumPy
   equivalent = measured NumPy per-iteration time x the same iteration
   count. (Fixed work, not to-tolerance: at this scale with random
   init the nonconvex NMF never reaches e_rel=1e-3/1e-4 within 3000
   iterations — true of the reference's math as well, so a
   to-tolerance wall-clock does not exist for either side.)

Roofline: the naive memory bound per iteration is read Y + read/write S
(+ read W when weighted), against the card's peak bandwidth from
:data:`PEAK_GBS` (an unknown card is an error).

Needs a GPU: without one it exits non-zero. Prints the card's name and
power limit and diagnostic lines to stderr, JSON lines to stdout; the
LAST stdout line is the headline metric. Secondary metrics are embedded
in the headline object under "extra" and also printed as their own JSON
lines.
"""
import json
import sys
import time

import numpy as np


C, K = 5, 7
N = 1_000_000
ITERS_LO, ITERS_HI = 200, 600
W_ITERS_LO, W_ITERS_HI = 50, 250
NUMPY_ITERS = 10
SEED = 101
STRIDE = 10
POWER_ITERS = 48       # cold-start passes (first refresh)
WARM_ITERS = 12        # warm-started passes (subsequent refreshes),
                       # matching proxmin_tpu.nmf.WeightedPGMStepper


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def make_problem(weighted=False):
    rng = np.random.default_rng(SEED)
    A_true = rng.random((C, K)).astype(np.float32)
    S_true = rng.random((K, N)).astype(np.float32)
    Y = (A_true @ S_true + 0.02 * rng.standard_normal((C, N))).astype(
        np.float32
    )
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)
    W = (0.5 + rng.random((C, N))).astype(np.float32) if weighted else None
    return Y, A0, S0, W


# --------------------------------------------------------------------------
# NumPy reference implementations (identical math)

def numpy_step(A, S, Y):
    """One unweighted PGM-NMF iteration in NumPy (reference per-iteration
    math: grad_likelihood + spectral steps + prox_plus + norms)."""
    D = A @ S - Y
    gA = D @ S.T
    gS = A.T @ D
    sA = 1.0 / np.linalg.eigvalsh(S @ S.T)[-1]
    sS = 1.0 / np.linalg.eigvalsh(A.T @ A)[-1]
    A_new = np.maximum(A - sA * gA, 0)
    S_new = np.maximum(S - sS * gS, 0)
    _ = ((A_new - A) ** 2).sum() <= 0 * (A_new ** 2).sum()
    _ = ((S_new - S) ** 2).sum() <= 0 * (S_new ** 2).sum()
    return A_new, S_new


def numpy_weighted_steps(A, S, W, v=None):
    """Weighted Lipschitz bounds, implicit (same algorithm as the device
    path): max_c lmax(S diag(W_c) S^T) via small eigh, and
    max_n lmax(A^T diag(W_n) A) via batched power iteration —
    warm-started from the previous refresh's iterate (cold
    POWER_ITERS passes on the first refresh, WARM_ITERS after),
    exactly like proxmin_tpu.nmf.WeightedPGMStepper."""
    H_A = np.einsum("kn,cn,ln->ckl", S, W, S)
    LA = max(np.linalg.eigvalsh(H_A[c])[-1] for c in range(W.shape[0]))

    if v is None:
        iters = POWER_ITERS
        v = np.ones((S.shape[1], A.shape[1]), S.dtype)
        v += 0.01 * np.arange(A.shape[1], dtype=S.dtype)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
    else:
        iters = WARM_ITERS
    for _ in range(iters):
        t = v @ A.T           # (N, C)
        u = W.T * t
        v = u @ A             # (N, K)
        v /= np.maximum(np.linalg.norm(v, axis=1, keepdims=True),
                        np.finfo(S.dtype).tiny)
    t = v @ A.T
    hv = (W.T * t) @ A
    rayleigh = (v * hv).sum(1) / np.maximum((v * v).sum(1),
                                            np.finfo(S.dtype).tiny)
    LS = rayleigh.max()
    v_next = hv / np.maximum(np.linalg.norm(hv, axis=1, keepdims=True),
                             np.finfo(S.dtype).tiny)
    return 1.0 / LA, 1.0 / LS, v_next


def numpy_weighted_step(A, S, Y, W, cached, it):
    """One weighted PGM-NMF iteration with the SAME stride-10 step
    caching + warm-started refresh the device side uses (0.9 safety)."""
    if it % STRIDE == 0:
        sA, sS, v = numpy_weighted_steps(A, S, W,
                                         None if cached is None
                                         else cached[2])
        cached = (0.9 * sA, 0.9 * sS, v)
    sA, sS, _ = cached
    D = W * (A @ S - Y)
    gA = D @ S.T
    gS = A.T @ D
    A_new = np.maximum(A - sA * gA, 0)
    S_new = np.maximum(S - sS * gS, 0)
    return A_new, S_new, cached


def bench_numpy(Y, A0, S0):
    A, S = A0.copy(), S0.copy()
    for _ in range(2):
        A, S = numpy_step(A, S, Y)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(NUMPY_ITERS):
            A, S = numpy_step(A, S, Y)
        best = min(best, (time.perf_counter() - t0) / NUMPY_ITERS)
    return best


def bench_numpy_weighted(Y, A0, S0, W):
    A, S = A0.copy(), S0.copy()
    cached = None
    A, S, cached = numpy_weighted_step(A, S, Y, W, cached, 0)  # warm
    best = float("inf")
    for rep in range(2):
        t0 = time.perf_counter()
        for i in range(STRIDE):   # one full stride period incl. refresh
            A, S, cached = numpy_weighted_step(A, S, Y, W, cached, i)
        best = min(best, (time.perf_counter() - t0) / STRIDE)
    return best


# --------------------------------------------------------------------------
# GPU timing

#: Peak memory bandwidth by ``jax.devices()[0].device_kind``, GB/s
#: (NVIDIA's data sheets: H100 SXM 3.35 TB/s, H200 SXM 4.8 TB/s).
PEAK_GBS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
    "NVIDIA H200": 4800.0,
}


def _timed(call, n_lo, n_hi, reps=3):
    """Marginal per-iteration time between two iteration counts: median
    of ``reps`` timed calls at each count (``call`` blocks until the
    device is done). Returns ``(marginal, median time at n_lo)``."""
    def run(n):
        t0 = time.perf_counter()
        call(n)
        return time.perf_counter() - t0

    t_lo = float(np.median([run(n_lo) for _ in range(reps)]))
    t_hi = float(np.median([run(n_hi) for _ in range(reps)]))
    return (t_hi - t_lo) / (n_hi - n_lo), t_lo


def roofline(label, t_iter, bytes_naive, peak_gbs):
    """Print achieved GB/s against the naive memory bound and the peak."""
    gbs = bytes_naive / t_iter / 1e9
    log(f"{label}: naive memory bound {bytes_naive / 1e6:.0f} MB/iter -> "
        f"achieved {gbs:.0f} GB/s vs {peak_gbs:.0f} GB/s peak")
    return gbs


def _block(res):
    """Wait for a solve's factors on the device."""
    import jax

    return jax.block_until_ready(res.x)


def bench_xla_step(Y, A0, S0, peak_gbs):
    """The reference's per-iteration math as one XLA fori_loop, and the
    fused Pallas runner on the same solve."""
    import jax
    import jax.numpy as jnp
    from proxmin_tpu import operators
    from proxmin_tpu.nmf import _make_fused_pgm_runner, pgm_nmf_iteration
    from proxmin_tpu.ops.nmf_kernels import pixel_tile

    Y_dev = jnp.asarray(Y)
    A = jnp.asarray(A0)
    S = jnp.asarray(S0)

    # Y rides as a jit ARGUMENT, exactly like the production drivers
    # (common.split_partial_data): a closure-captured Y would be an HLO
    # constant baked into the program
    @jax.jit
    def run_xla(A, S, Y, n):
        def body(i, carry):
            A, S, _ = carry
            return pgm_nmf_iteration(A, S, Y)

        return jax.lax.fori_loop(0, n, body, (A, S, jnp.asarray(False)))

    t0 = time.perf_counter()
    compiled_obj = run_xla.lower(A, S, Y_dev, ITERS_LO).compile()
    compile_time = time.perf_counter() - t0

    def call_xla(n):
        # the iteration count is a traced scalar: one compiled object
        # serves every n
        return jax.block_until_ready(compiled_obj(A, S, Y_dev, jnp.int32(n)))

    call_xla(ITERS_LO)
    t_xla, first = _timed(call_xla, ITERS_LO, ITERS_HI)
    fixed = max(first - ITERS_LO * t_xla, 0.0)
    log(f"gpu/xla:    {t_xla * 1e3:.3f} ms/iter (marginal; "
        f"~{fixed * 1e3:.0f} ms fixed/call; compile {compile_time:.1f}s)")

    # naive bound: read Y (C*N) + read S + write S (K*N each), f32
    bytes_naive = (C * N + 2 * K * N) * 4
    gbs = roofline("gpu/xla", t_xla, bytes_naive, peak_gbs)

    run_pallas = _make_fused_pgm_runner(
        operators.prox_plus, None, 0.0, pixel_tile(K, N), C, K, N,
        jnp.float32.dtype)

    def call_pallas(n):
        return jax.block_until_ready(run_pallas(A, S, Y_dev, n)[:2])

    call_pallas(ITERS_LO)  # compile
    t_pal, first = _timed(call_pallas, ITERS_LO, ITERS_HI)
    fixed = max(first - ITERS_LO * t_pal, 0.0)
    log(f"gpu/pallas: {t_pal * 1e3:.3f} ms/iter (marginal; "
        f"~{fixed * 1e3:.0f} ms fixed/call)")
    roofline("gpu/pallas", t_pal, bytes_naive, peak_gbs)

    if t_pal < t_xla:
        return t_pal, "pallas", gbs, compile_time
    return t_xla, "xla", gbs, compile_time


def bench_unweighted_strided(Y, A0, S0, peak_gbs):
    """Unweighted flagship with the STRIDED step policy on both engines
    (``step_adapt=True``, in-carry ApproximateCache growth): the XLA
    driver skips its per-iteration ``S S^T`` Gram + eigensolves between
    refreshes, the fused runner's segmented frozen-step inner loop drops
    its in-loop eigensolves."""
    import jax.numpy as jnp
    import proxmin_tpu as pt

    Y_dev = jnp.asarray(Y)
    A = jnp.asarray(A0)
    S = jnp.asarray(S0)
    bytes_naive = (C * N + 2 * K * N) * 4

    out = {}
    for name, kw in (
        ("xla-adapt", dict(step_adapt=True, engine="xla")),
        ("pallas-adapt", dict(step_adapt=True, engine="pallas")),
    ):
        def call(n, _kw=kw):
            return _block(pt.nmf.nmf(Y_dev, A, S, e_rel=0, max_iter=n,
                                     **_kw))

        call(ITERS_LO)  # compile
        t_s, first = _timed(call, ITERS_LO, ITERS_HI)
        fixed = max(first - ITERS_LO * t_s, 0.0)
        log(f"gpu/unweighted[{name}]: {t_s * 1e3:.3f} ms/iter "
            f"(marginal; ~{fixed * 1e3:.0f} ms fixed/call)")
        roofline(f"gpu/unweighted[{name}]", t_s, bytes_naive, peak_gbs)
        out[name] = t_s
    return out


def bench_weighted(Y, A0, S0, W, peak_gbs):
    """Weighted flagship through the production ``nmf()`` driver: the XLA
    driver with the warm-started
    :class:`~proxmin_tpu.nmf.WeightedPGMStepper` (fixed and adaptive
    stride) and the fused single-pass Pallas runner (same policies)."""
    import jax.numpy as jnp
    import proxmin_tpu as pt

    Y_dev = jnp.asarray(Y)
    W_dev = jnp.asarray(W)
    A = jnp.asarray(A0)
    S = jnp.asarray(S0)
    bytes_naive = (2 * C * N + 2 * K * N) * 4  # + W read per iteration

    out = {}
    variants = (
        ("xla-stride", dict(step_stride=STRIDE, engine="xla")),
        ("xla-adapt", dict(step_stride=STRIDE, step_adapt=True,
                           engine="xla")),
        ("pallas-stride", dict(step_stride=STRIDE, engine="pallas")),
        ("pallas-adapt", dict(step_stride=STRIDE, step_adapt=True,
                              engine="pallas")),
    )
    for name, kw in variants:
        def call(n, _kw=kw):
            return _block(pt.nmf.nmf(Y_dev, A, S, W=W_dev, e_rel=0,
                                     max_iter=n, **_kw))

        t0 = time.perf_counter()
        call(W_ITERS_LO)  # compile
        compile_time = time.perf_counter() - t0
        t_w, first = _timed(call, W_ITERS_LO, W_ITERS_HI)
        fixed = max(first - W_ITERS_LO * t_w, 0.0)
        log(f"gpu/weighted[{name}]: {t_w * 1e3:.3f} ms/iter "
            f"(marginal; ~{fixed * 1e3:.0f} ms fixed/call; "
            f"compile {compile_time:.1f}s)")
        roofline(f"gpu/weighted[{name}]", t_w, bytes_naive, peak_gbs)
        out[name] = t_w
    return out


def bench_adaprox(Y, A0, S0):
    """AdaProx flagship: the XLA driver with the separable closed-form
    prox, and the fused single-pass Pallas Adam+prox kernel with f32 and
    with bf16 moments."""
    import jax.numpy as jnp
    import proxmin_tpu as pt

    Y_dev = jnp.asarray(Y)
    A = jnp.asarray(A0)
    S = jnp.asarray(S0)

    variants = (
        ("xla-separable", dict()),
        ("pallas-fused", dict(engine="pallas")),
        ("pallas-fused-bf16m", dict(engine="pallas",
                                    moment_dtype=jnp.bfloat16)),
    )
    out = {}
    for name, kw in variants:
        def call(n, _kw=kw):
            return _block(pt.nmf.nmf(Y_dev, A, S, algorithm="adaprox",
                                     e_rel=0, max_iter=n,
                                     separable_prox="auto", **_kw))

        call(ITERS_LO)  # compile
        t_a, first = _timed(call, ITERS_LO, ITERS_HI)
        fixed = max(first - ITERS_LO * t_a, 0.0)
        log(f"gpu/adaprox[{name}]: {t_a * 1e3:.3f} ms/iter (marginal; "
            f"~{fixed * 1e3:.0f} ms fixed/call)")
        out[name] = t_a
    return out


E2E_ITERS = 2000


def bench_e2e(Y, A0, S0):
    """End-to-end fixed-work solve (2000 iterations through the full
    production nmf() driver): one compiled call, wall-clock INCLUDING
    fixed dispatch/transfer overhead and the driver's per-iteration
    convergence machinery; also the driver's marginal slope + fixed cost
    per call between two iteration budgets."""
    import jax.numpy as jnp
    import proxmin_tpu as pt

    Y_dev = jnp.asarray(Y)
    A = jnp.asarray(A0)
    S = jnp.asarray(S0)

    def call(n):
        res = pt.nmf.nmf(Y_dev, A, S, e_rel=0, max_iter=n)
        _block(res)
        return res

    res = call(E2E_ITERS)  # compile
    iters = res.iterations
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        call(E2E_ITERS)
        times.append(time.perf_counter() - t0)
    best = float(np.median(times))
    log(f"gpu e2e solve: {best:.3f} s for {iters} iters "
        f"(one compiled call incl. dispatch + convergence machinery)")

    call(ITERS_LO)  # compile the lo budget
    marg, t_lo = _timed(call, ITERS_LO, E2E_ITERS)
    fixed = max(t_lo - ITERS_LO * marg, 0.0)
    log(f"gpu driver: {marg * 1e3:.3f} ms/iter marginal, "
        f"~{fixed * 1e3:.0f} ms fixed/call")
    return best, iters, marg, fixed


def device_info():
    """The GPU this run measures: JAX's view, nvidia-smi's name and power
    limit, and its peak bandwidth. Exits when there is no GPU or the
    card is not in :data:`PEAK_GBS`."""
    import subprocess

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"FATAL: no GPU (JAX found {jax.devices()}); this benchmark "
            "measures the GPU only")
        sys.exit(1)
    if dev.device_kind not in PEAK_GBS:
        log(f"FATAL: no peak bandwidth recorded for {dev.device_kind!r}; "
            "add it to PEAK_GBS with its source")
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(f"card: {smi}; jax: {jax.devices()}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "nvidia_smi": smi}, \
        PEAK_GBS[dev.device_kind]


def main():
    device, peak_gbs = device_info()
    Y, A0, S0, W = make_problem(weighted=True)
    log(f"problem: Y {C}x{N}, K={K}, float32")

    t_np = bench_numpy(Y, A0, S0)
    log(f"numpy: {t_np * 1e3:.2f} ms/iter")
    t_np_w = bench_numpy_weighted(Y, A0, S0, W)
    log(f"numpy weighted (strided, implicit): {t_np_w * 1e3:.2f} ms/iter")

    # fixed-iteration timing solves each emit a "did not converge"
    # WARNING through the production drivers; collapse them to one
    # summary line so a real regression warning stays visible
    from proxmin_tpu.utils import summarize_convergence_warnings

    with summarize_convergence_warnings():
        t_dev, engine, gbs, compile_s = bench_xla_step(Y, A0, S0, peak_gbs)
        log(f"gpu best ({engine}): {t_dev * 1e3:.3f} ms/iter")
        t_us = bench_unweighted_strided(Y, A0, S0, peak_gbs)
        t_ws = bench_weighted(Y, A0, S0, W, peak_gbs)
        t_dev_w = min(t_ws.values())
        t_as = bench_adaprox(Y, A0, S0)
        # headline stays the full-precision number; the bf16-moment
        # fused row is reported alongside, clearly labeled (reduced
        # moment precision is an opt-in, not a silent default)
        t_dev_a = t_as["xla-separable"]
        t_e2e, e2e_iters, t_drv, fixed_drv = bench_e2e(Y, A0, S0)

    speedup = t_np / t_dev
    speedup_w = t_np_w / t_dev_w
    e2e_numpy_equiv = t_np * e2e_iters
    e2e_speedup = e2e_numpy_equiv / t_e2e

    extra = {
        "device": device,
        "weighted_stride10_per_iter_speedup_vs_numpy": round(speedup_w, 1),
        "weighted_gpu_ms_per_iter": round(t_dev_w * 1e3, 4),
        "weighted_variants_ms_per_iter": {
            k: round(v * 1e3, 4) for k, v in t_ws.items()
        },
        "flagship_compile_seconds": round(compile_s, 1),
        "e2e_2000iter_seconds": round(t_e2e, 3),
        "e2e_iterations": e2e_iters,
        "e2e_speedup_vs_numpy_equiv": round(e2e_speedup, 1),
        "driver_marginal_ms_per_iter": round(t_drv * 1e3, 4),
        "driver_fixed_ms_per_call": round(fixed_drv * 1e3, 1),
        "best_ms_per_iter": round(t_dev * 1e3, 4),
        "unweighted_strided_variants_ms_per_iter": {
            k: round(v * 1e3, 4) for k, v in t_us.items()
        },
        "unweighted_best_any_policy_ms_per_iter": round(
            min(t_dev, min(t_us.values())) * 1e3, 4),
        "adaprox_separable_ms_per_iter": round(t_dev_a * 1e3, 4),
        "adaprox_variants_ms_per_iter": {
            k: round(v * 1e3, 4) for k, v in t_as.items()
        },
        "adaprox_best_ms_per_iter": round(min(t_as.values()) * 1e3, 4),
        "numpy_ms_per_iter": round(t_np * 1e3, 2),
        "achieved_gbs_vs_naive_memory_bound": round(gbs, 0),
        "peak_gbs": peak_gbs,
    }
    # secondary metrics as their own JSON lines (machine-capturable), the
    # headline LAST so tail-parsers keep working
    print(json.dumps({
        "metric": "nmf_pgm_1e6px_weighted_stride10_per_iter_speedup",
        "value": round(speedup_w, 1), "unit": "x",
        "vs_baseline": round(speedup_w, 1),
    }))
    print(json.dumps({
        "metric": "nmf_pgm_1e6px_e2e_2000iter_seconds",
        "value": round(t_e2e, 3), "unit": "s",
        "vs_baseline": round(e2e_speedup, 1),
    }))
    print(json.dumps({
        "metric": "nmf_pgm_1e6px_per_iter_speedup_vs_numpy",
        "value": round(speedup, 1),
        "unit": "x",
        "vs_baseline": round(speedup, 1),
        "extra": extra,
    }))


if __name__ == "__main__":
    main()
