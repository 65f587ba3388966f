"""Smoke test of proxmin_tpu's NMF and solver path on one NVIDIA GPU.

    python chip_smoke.py            # phases (a)-(e) on one GPU
    python chip_smoke.py --multi    # only the sharded whole-solve, 4 GPUs

Drives the main path through the public entry points at the flagship width
(C=5 channels, K=7 components, N=1,000,000 pixels, f32; data made from a
seed) and checks each result against a plain reference:

(a) unweighted ``nmf()`` on the default engine vs the NumPy iteration of
    ``bench.numpy_step``; the loss goes down over a few hundred iterations;
(b) weighted ``nmf()`` with ``step_stride=10, step_adapt=True`` vs the NumPy
    strided iteration of ``bench.numpy_weighted_step``;
(c) ``algorithm="adaprox"`` (default and ``engine="auto"``): finite, loss
    goes down;
(d) the precision-sensitive unmixing problem (C=16, K=4, N=512,
    ``e_rel=1e-4``) converges, in the NumPy oracle's iteration count;
(e) every fused kernel, compiled for the card, at the flagship (weighted
    and unweighted) and at the AVIRIS Cuprite width (C=188, K=12,
    N=250x190): compared with the plain ``jax.numpy`` step at HIGHEST
    precision, and timed against what XLA makes of that step and against
    the XLA engine end to end (ms/iter).

Exits non-zero, printing no ``ok`` line, when JAX finds no GPU or any phase
fails. The last line of a passing run is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

import argparse
import json
import subprocess
import sys
import time
import traceback
from functools import partial

import numpy as np

TOL_ITERATE = 1e-3
TOL_KERNEL = 1e-4
WIDE = (188, 12, 250 * 190)   # AVIRIS Cuprite: 188 bands, 250x190 pixels
ITERS = (20, 220)             # marginal ms/iter between these budgets
REPS = 3


def log(msg):
    print(msg, flush=True)


def rel_err(x, ref):
    x = np.asarray(x, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(x - ref)) / max(np.max(np.abs(ref)), 1e-30))


def loss_np(Y, A, S, W=None):
    R = np.asarray(Y, np.float64) - (np.asarray(A, np.float64)
                                     @ np.asarray(S, np.float64))
    return 0.5 * float(np.sum((1.0 if W is None else W) * R * R))


def check(name, ok, detail):
    log(f"  {name}: {'ok' if ok else 'FAILED'} ({detail})")
    if not ok:
        raise AssertionError(f"{name}: {detail}")


def marginal_ms(call):
    """Median marginal ms/iter of ``call(n)`` between the ITERS budgets
    (the first call compiles and is not timed)."""
    import jax

    def run(n):
        t0 = time.perf_counter()
        jax.block_until_ready(call(n))
        return time.perf_counter() - t0

    run(ITERS[0])
    run(ITERS[1])
    lo = np.median([run(ITERS[0]) for _ in range(REPS)])
    hi = np.median([run(ITERS[1]) for _ in range(REPS)])
    return float((hi - lo) / (ITERS[1] - ITERS[0]) * 1e3)


def phase_a(bench, pt, jnp):
    """Unweighted flagship through nmf() on the default engine."""
    Y, A0, S0, _ = bench.make_problem()
    res = pt.nmf.nmf(jnp.asarray(Y), jnp.asarray(A0), jnp.asarray(S0),
                     e_rel=0, max_iter=20)
    A, S = A0.copy(), S0.copy()
    for _ in range(20):
        A, S = bench.numpy_step(A, S, Y)
    eA, eS = rel_err(res.x[0], A), rel_err(res.x[1], S)
    check("20 iterations vs NumPy", res.iterations == 20
          and max(eA, eS) <= TOL_ITERATE,
          f"max rel. error A {eA:.2e}, S {eS:.2e}; tolerance {TOL_ITERATE:g}: "
          "f32 with another summation order over 1e6 pixels, compounded "
          "over 20 iterations")
    res = pt.nmf.nmf(jnp.asarray(Y), jnp.asarray(A0), jnp.asarray(S0),
                     e_rel=0, max_iter=300)
    l0, l1 = loss_np(Y, A0, S0), loss_np(Y, *res.x)
    check("300 iterations: loss goes down", np.isfinite(l1) and l1 < l0,
          f"loss {l0:.6g} -> {l1:.6g}")


def _numpy_adaptive_weighted(bench, A, S, Y, W, iters, stride=10,
                             safety=0.9, max_stride=100):
    """bench.numpy_weighted_step's strided, warm-started refresh with the
    adaptive interval of ``step_adapt=True`` (``utils.grow_stride``): grow
    while the step drift stays under half the safety slack, halve above
    it, the first refresh pinned."""
    budget = (1.0 - safety) / 2
    cached, v, nxt = None, None, 0
    for it in range(iters):
        if it >= nxt:
            sA, sS, v = bench.numpy_weighted_steps(A, S, W, v)
            new = (safety * sA, safety * sS)
            if cached is not None:
                drift = max(abs(n - o) / abs(o) for o, n in zip(cached, new))
                if 0 < drift < budget:
                    stride = min(max_stride,
                                 stride + max(1, int(budget / drift * stride)))
                elif drift > budget:
                    stride = max(1, stride // 2)
            cached, nxt = new, it + stride
        D = W * (A @ S - Y)
        A, S = (np.maximum(A - cached[0] * (D @ S.T), 0),
                np.maximum(S - cached[1] * (A.T @ D), 0))
    return A, S


def phase_b(bench, pt, jnp):
    """Weighted flagship, strided adaptive steps, vs NumPy."""
    Y, A0, S0, W = bench.make_problem(weighted=True)
    res = pt.nmf.nmf(jnp.asarray(Y), jnp.asarray(A0), jnp.asarray(S0),
                     W=jnp.asarray(W), e_rel=0, max_iter=20,
                     step_stride=10, step_adapt=True)
    A, S = _numpy_adaptive_weighted(bench, A0.copy(), S0.copy(), Y, W, 20)
    eA, eS = rel_err(res.x[0], A), rel_err(res.x[1], S)
    check("20 iterations vs NumPy strided", res.iterations == 20
          and max(eA, eS) <= TOL_ITERATE,
          f"max rel. error A {eA:.2e}, S {eS:.2e}; tolerance {TOL_ITERATE:g}: "
          "as (a), plus f32 power iterations for the weighted bounds")


def phase_c(bench, pt, jnp):
    """AdaProx on the flagship: default engine and engine='auto'."""
    Y, A0, S0, _ = bench.make_problem()
    l0 = loss_np(Y, A0, S0)
    for engine in ("xla", "auto"):
        res = pt.nmf.nmf(jnp.asarray(Y), jnp.asarray(A0), jnp.asarray(S0),
                         algorithm="adaprox", e_rel=0, max_iter=200,
                         engine=engine)
        l1 = loss_np(Y, *res.x)
        ran = "fused kernel" if "fused_config" in res.state else "XLA"
        finite = all(np.isfinite(np.asarray(x)).all() for x in res.x)
        check(f"engine={engine} ({ran}), 200 iterations",
              finite and l1 < l0, f"finite; loss {l0:.6g} -> {l1:.6g}")


def _unmixing_problem():
    rng = np.random.default_rng(1000)
    C, K, N = 16, 4, 512
    A_true = rng.random((C, K))
    S_true = rng.random((K, N))
    Y = (A_true @ S_true + 0.02 * rng.standard_normal((C, N))).astype(
        np.float32)
    return Y, rng.random((C, K)).astype(np.float32), \
        rng.random((K, N)).astype(np.float32)


def _unmixing_numpy_iterations(Y, A, S):
    """The f32 NumPy oracle of tests/test_precision.py."""
    dt = np.float32
    for it in range(5000):
        sA = (1.0 / np.linalg.eigvalsh(S @ S.T)[-1]).astype(dt)
        sS = (1.0 / np.linalg.eigvalsh(A.T @ A)[-1]).astype(dt)
        D = A @ S - Y
        A1 = np.maximum(A - sA * (D @ S.T), 0)
        A1 = A1 / np.maximum(A1.sum(1, keepdims=True), np.finfo(dt).tiny)
        S1 = np.maximum(S - sS * (A.T @ D), 0)
        done = (((A1 - A) ** 2).sum() <= 1e-8 * (A1 ** 2).sum()
                and ((S1 - S) ** 2).sum() <= 1e-8 * (S1 ** 2).sum())
        A, S = A1, S1
        if done:
            return it + 1
    return None


def phase_d(bench, pt, jnp):
    """The precision-sensitive unmixing problem converges on the GPU."""
    Y, A0, S0 = _unmixing_problem()
    it_np = _unmixing_numpy_iterations(Y, A0.copy(), S0.copy())
    res = pt.nmf.nmf(jnp.asarray(Y), jnp.asarray(A0), jnp.asarray(S0),
                     prox_A=partial(pt.operators.prox_unity_plus, axis=1),
                     e_rel=1e-4, max_iter=5000)
    slack = max(5, int(0.01 * it_np))
    check("converges at e_rel=1e-4", all(res.converged)
          and abs(res.iterations - it_np) <= slack,
          f"GPU {res.iterations} iterations, CPU f32 (NumPy) {it_np}; "
          f"tolerance +-{slack} iterations, as in tests/test_precision.py: "
          "same math, another reduction order")


def _plain_pgm_step(A, S, Y, W, sS):
    import jax.numpy as jnp

    R = A @ S - Y
    D = R if W is None else W * R
    S_new = jnp.maximum(S - sS * (A.T @ D), 0.0)
    return (D @ S.T, S_new, S_new @ S_new.T, jnp.sum(D * R) / 2,
            jnp.sum((S_new - S) ** 2), jnp.sum(S_new * S_new))


def _plain_adaprox_step(A, S, M, V, Y, W, alpha, sc, b2=0.999, eps=1e-8):
    import jax.numpy as jnp

    R = A @ S - Y
    D = R if W is None else W * R
    gS = A.T @ D
    M1 = (1 - sc[0]) * gS + sc[0] * M
    V1 = (1 - b2) * gS * gS + b2 * V
    S1 = jnp.maximum(
        S - alpha[:, None] * M1 * sc[1] / (jnp.sqrt(V1 * sc[2]) + eps), 0)
    return (D @ S.T, S1, M1, V1, jnp.sum(S1, axis=1), jnp.sum(D * R) / 2,
            jnp.sum((S1 - S) ** 2), jnp.sum(S1 * S1))


def _looped(step, n, S_index):
    """n chained steps in one jit (the new S feeds the next step)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(args):
        def body(_, carry):
            S, acc = carry
            a = list(args)
            a[S_index] = S
            out = step(*a)
            acc = acc + sum(jnp.sum(o) for o in out if o is not out[1])
            return out[1], acc
        return jax.lax.fori_loop(0, n, body,
                                 (args[S_index], jnp.float32(0)))
    return run


def _step_ms(step, args, S_index):
    runs = {n: _looped(step, n, S_index) for n in ITERS}
    return marginal_ms(lambda n: runs[n](args))


def phase_e(bench, pt, jnp):
    """Every kernel compiled for the card, checked and timed."""
    import jax

    from proxmin_tpu.ops import nmf_kernels as nk

    rng = np.random.default_rng(bench.SEED)
    rows = []
    for shape_name, (C, K, N) in (("flagship", (bench.C, bench.K, bench.N)),
                                  ("cuprite", WIDE)):
        for weighted in (False, True):
            A = jnp.asarray(rng.random((C, K), np.float32))
            S = jnp.asarray(rng.random((K, N), np.float32))
            Y = jnp.asarray(rng.random((C, N), np.float32))
            W = (jnp.asarray((0.5 + rng.random((C, N))).astype(np.float32))
                 if weighted else None)
            M = jnp.asarray(rng.random((K, N), np.float32))
            V = jnp.asarray(rng.random((K, N), np.float32))
            alpha = jnp.full((K,), 1e-3, jnp.float32)
            sc = jnp.asarray([0.9, 1 / (1 - 0.9 ** 3), 1 / (1 - 0.999 ** 3)],
                             jnp.float32)
            tag = f"{shape_name} C={C} K={K} N={N} " + (
                "weighted" if weighted else "unweighted")
            kernels = (
                ("pgm", lambda A, S, Y, W: nk.fused_nmf_pgm_step(
                    A, S, Y, 1e-4, W=W, interpret=False),
                 lambda A, S, Y, W: _plain_pgm_step(A, S, Y, W, 1e-4),
                 (A, S, Y, W)),
                ("adaprox", lambda A, S, M, V, Y, W: nk.fused_nmf_adaprox_step(
                    A, S, M, V, Y, alpha, sc, W=W, interpret=False),
                 lambda A, S, M, V, Y, W: _plain_adaprox_step(
                     A, S, M, V, Y, W, alpha, sc),
                 (A, S, M, V, Y, W)),
            )
            for kname, kern, plain, args in kernels:
                t0 = time.perf_counter()
                out_k = jax.block_until_ready(jax.jit(kern)(*args))
                t_compile = time.perf_counter() - t0
                with jax.default_matmul_precision("highest"):
                    out_p = jax.jit(plain)(*args)
                    err = max(rel_err(a, b) for a, b in zip(out_k, out_p))
                    t_xla = _step_ms(plain, args, 1)
                t_kernel = _step_ms(kern, args, 1)
                check(f"{kname} kernel, {tag}", err <= TOL_KERNEL,
                      f"compile+first call {t_compile:.1f}s; max rel. error "
                      f"{err:.1e} vs the plain step at HIGHEST, tolerance "
                      f"{TOL_KERNEL:g}: exact f32 products, sums over "
                      f"{N} pixels in another order; step {t_kernel:.4f} "
                      f"ms (kernel) vs {t_xla:.4f} ms (XLA)")
                rows.append(dict(kernel=kname, shape=tag, level="step",
                                 kernel_ms=t_kernel, xla_ms=t_xla))

            # end to end: the fused runner vs the XLA engine, same solve
            data = dict(Y=Y, A=A, S=S, W=W if weighted else 1)
            solves = (
                ("pgm", dict(step_stride=10, step_adapt=True)
                 if weighted else {}),
                ("adaprox", dict(algorithm="adaprox",
                                 separable_prox="auto")),
            )
            for kname, kw in solves:
                ms = {}
                for engine in ("pallas", "xla"):
                    def call(n, engine=engine, kw=kw):
                        r = pt.nmf.nmf(data["Y"], data["A"], data["S"],
                                       W=data["W"], e_rel=0, max_iter=n,
                                       engine=engine, **kw)
                        return r.x
                    ms[engine] = marginal_ms(call)
                log(f"  {kname} solve, {tag}: {ms['pallas']:.4f} ms/iter "
                    f"(fused kernel) vs {ms['xla']:.4f} ms/iter (XLA engine)")
                rows.append(dict(kernel=kname, shape=tag, level="solve",
                                 kernel_ms=ms["pallas"], xla_ms=ms["xla"]))
    log("phase (e) table: " + json.dumps(rows))


def phase_multi(bench, pt, jnp):
    """Sharded whole-solve on 4 GPUs vs the same solve on one."""
    import jax

    from proxmin_tpu.parallel import (make_mesh, nmf_pgm_sharded,
                                      shard_nmf_problem)

    devs = jax.devices()
    check("four GPUs", len(devs) == 4, f"{len(devs)} devices")
    Y, A0, S0, W = bench.make_problem(weighted=True)
    for weighted in (False, True):
        kw = dict(step_stride=10, step_adapt=True) if weighted else {}
        Wd = W if weighted else 1
        one = jax.devices()[0]
        with jax.default_device(one):
            ref = pt.nmf.nmf(jnp.asarray(Y), jnp.asarray(A0),
                             jnp.asarray(S0), W=Wd, e_rel=0, max_iter=50,
                             **kw)
        # C=5 does not split over a model axis, so the 2x2 mesh shards
        # the pixels over both of its axes
        for shape, data_axis in (((4,), "data"), ((2, 2), ("data", "model"))):
            mesh = make_mesh(shape)
            Ys, As, Ss, Ws = shard_nmf_problem(
                mesh, Y, A0, S0, W if weighted else None,
                data_axis=data_axis)
            placed = [s.device for s in Ys.addressable_shards]
            check(f"mesh {shape}: one shard per GPU",
                  sorted(d.id for d in placed) == sorted(d.id for d in devs),
                  f"Y shards on {sorted(d.id for d in placed)}")
            t0 = time.perf_counter()
            if data_axis == "data":
                res = pt.nmf.nmf(Ys, As, Ss, W=Ws if weighted else 1,
                                 e_rel=0, max_iter=50, mesh=mesh, **kw)
            else:
                res = nmf_pgm_sharded(Ys, As, Ss, W=Ws, mesh=mesh,
                                      e_rel=0, max_iter=50,
                                      data_axis=data_axis, **kw)
            secs = time.perf_counter() - t0
            eA = rel_err(res.x[0], ref.x[0])
            eS = rel_err(res.x[1], ref.x[1])
            check(f"mesh {shape} {'weighted' if weighted else 'unweighted'}"
                  " 50 iterations vs one GPU",
                  res.iterations == 50 and max(eA, eS) <= TOL_ITERATE,
                  f"max rel. error A {eA:.2e}, S {eS:.2e}; tolerance "
                  f"{TOL_ITERATE:g}: the pixel sums are split over four "
                  f"cards and added in another order; {secs:.1f}s incl. "
                  "compile")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--multi", action="store_true",
                        help="run only the sharded whole-solve on 4 GPUs")
    args = parser.parse_args()

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices}", file=sys.stderr)
        return 2
    try:
        import jax.numpy as jnp

        import bench
        import proxmin_tpu as pt
    except ImportError as exc:
        print(f"proxmin_tpu is not importable here: {exc}", file=sys.stderr)
        return 2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    log(smi.stdout.strip())
    log(f"jax {jax.__version__}: {devices}")

    phases = ([("multi", phase_multi)] if args.multi else
              [("a", phase_a), ("b", phase_b), ("c", phase_c),
               ("d", phase_d), ("e", phase_e)])
    failed = []
    from proxmin_tpu.utils import summarize_convergence_warnings

    for name, fn in phases:
        log(f"phase ({name}): {fn.__doc__.splitlines()[0]}")
        t0 = time.perf_counter()
        try:
            with summarize_convergence_warnings():
                fn(bench, pt, jnp)
        except Exception:  # report every phase, then fail the run
            traceback.print_exc()
            failed.append(name)
        log(f"phase ({name}): {time.perf_counter() - t0:.1f}s")
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
