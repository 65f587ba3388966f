"""Scaling harness: the sharded PGM-NMF flagship over a parametrized
mesh.

Runs the whole-solve shard_map (``proxmin_tpu.parallel.nmf_pgm_sharded``,
the ``nmf(mesh=...)`` pgm path) at 1/2/4/8-way pixel sharding — optionally
with a two-level ``("host", "data")`` axis split (the multi-host layout)
— and reports, per mesh size:

* measured **ms/iter** (marginal between two iteration counts of the
  compiled whole-solve, min over repetitions — cancels dispatch/compile);
* the **modeled per-iteration collective volume** from the design table
  (docs/DESIGN.md "Per-iteration communication volume");
* the **HLO-verified collective inventory** of the compiled program
  (op, shape, count) — the same optimized-HLO extraction the
  collective-layout audit tests pin, so the modeled volume is checked
  against what XLA actually emits, not against intentions.

The harness runs on the virtual 8-device CPU mesh (``--virtual``;
CI-smoked by ``tests/test_pod_scaling.py``) and unchanged on a host with
several GPUs.

Usage:
    python benchmarks/pod_scaling.py --virtual --devices 1,2,4,8
    python benchmarks/pod_scaling.py --virtual --two-level --weighted
    python benchmarks/pod_scaling.py --devices 1,4 --N 4194304  # 4 GPUs

Prints one JSON line per mesh configuration.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--devices", default="1,2,4,8",
                    help="comma-separated mesh sizes to sweep")
    ap.add_argument("--C", type=int, default=5)
    ap.add_argument("--K", type=int, default=7)
    ap.add_argument("--N", type=int, default=262144,
                    help="pixel count (default 256k; use 1e6+ on real "
                         "hardware)")
    ap.add_argument("--iters-lo", type=int, default=50)
    ap.add_argument("--iters-hi", type=int, default=150)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--weighted", action="store_true")
    ap.add_argument("--step-stride", type=int, default=10,
                    help="weighted Lipschitz refresh stride")
    ap.add_argument("--two-level", action="store_true",
                    help="split the pixel axis over ('host', 'data') "
                         "instead of a flat ('data',) axis")
    ap.add_argument("--virtual", action="store_true",
                    help="run on a virtual 8-device CPU mesh (no "
                         "GPUs needed)")
    return ap.parse_args(argv)


def collective_inventory(hlo_text):
    """{"op[sizes]": count} over an optimized HLO dump, built on the
    package's auditing primitive (proxmin_tpu.parallel.hlo_collectives
    — one extractor shared with tests/test_collective_layout.py)."""
    from proxmin_tpu.parallel import hlo_collectives

    inv = {}
    for op, sizes in hlo_collectives(hlo_text):
        key = (op, tuple(sorted(sizes)))
        inv[key] = inv.get(key, 0) + 1
    return {f"{op}{list(sz)}": c for (op, sz), c in sorted(inv.items())}


def modeled_comm_bytes_per_iter(C, K, weighted, stride, dtype_bytes=4):
    """Design-table per-iteration all-reduce volume (docs/DESIGN.md):
    grad_A (C,K) + unweighted Gram (K,K) + 3 convergence/loss scalars;
    weighted strided replaces the in-body Gram with a (C,K,K) refresh
    psum amortized over the stride."""
    base = C * K + 3
    if weighted:
        base += C * K * K / max(stride, 1)
    else:
        base += K * K
    return dtype_bytes * base


def run_scaling(device_counts, C=5, K=7, N=262144, iters_lo=50,
                iters_hi=150, reps=3, weighted=False, step_stride=10,
                two_level=False, log=print):
    """Sweep mesh sizes; returns a list of result dicts."""
    import numpy as np
    import jax

    from proxmin_tpu.operators import prox_plus
    from proxmin_tpu.parallel import make_mesh, shard_nmf_problem
    from proxmin_tpu.parallel.sharding import _build_pgm_solve

    rng = np.random.default_rng(101)
    A_true = rng.random((C, K)).astype(np.float32)
    S_true = rng.random((K, N)).astype(np.float32)
    Y = (A_true @ S_true
         + 0.02 * rng.standard_normal((C, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)
    W = ((0.5 + rng.random((C, N))).astype(np.float32)
         if weighted else None)

    results = []
    for d in device_counts:
        if d > len(jax.devices()):
            log(f"# skipping {d}-way (only {len(jax.devices())} devices)")
            continue
        if N % d:
            log(f"# skipping {d}-way (N={N} not divisible)")
            continue
        if two_level and d >= 2:
            mesh = make_mesh(shape=(2, d // 2), axis_names=("host", "data"))
            data_axis = ("host", "data")
        else:
            mesh = make_mesh(shape=(d,))
            data_axis = "data"

        Ys, As, Ss, Wsh = shard_nmf_problem(mesh, Y, A0, S0, W,
                                            data_axis=data_axis)
        if Wsh is None:
            import jax.numpy as jnp
            Wsh = jnp.ones_like(Ys)

        stride = step_stride if weighted else None
        solve = _build_pgm_solve(mesh, weighted, prox_plus, prox_plus,
                                 0.0, iters_lo, data_axis, None, stride,
                                 False)
        solve_hi = _build_pgm_solve(mesh, weighted, prox_plus, prox_plus,
                                    0.0, iters_hi, data_axis, None,
                                    stride, False)

        hlo = solve.lower(As, Ss, Ys, Wsh).compile().as_text()

        def timed(fn):
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                out = fn(As, Ss, Ys, Wsh)
                # force completion with a tiny host transfer
                float(out[5])
                best = min(best, time.perf_counter() - t0)
            return best

        timed(solve)          # warm both compiles
        timed(solve_hi)
        t_lo = timed(solve)
        t_hi = timed(solve_hi)
        ms_iter = (t_hi - t_lo) / (iters_hi - iters_lo) * 1e3

        row = {
            "devices": d,
            "two_level": bool(two_level and d >= 2),
            "weighted": weighted,
            "C": C, "K": K, "N": N,
            "ms_per_iter": round(ms_iter, 4),
            "modeled_comm_bytes_per_iter": modeled_comm_bytes_per_iter(
                C, K, weighted, step_stride),
            "hlo_collectives": collective_inventory(hlo),
        }
        results.append(row)
        log(json.dumps(row))
    return results


def main(argv=None):
    args = _parse_args(argv)
    if args.virtual:
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8"
            ).strip()
    import jax
    if args.virtual:
        jax.config.update("jax_platforms", "cpu")

    device_counts = [int(x) for x in args.devices.split(",")]
    run_scaling(device_counts, C=args.C, K=args.K, N=args.N,
                iters_lo=args.iters_lo, iters_hi=args.iters_hi,
                reps=args.reps, weighted=args.weighted,
                step_stride=args.step_stride, two_level=args.two_level)


if __name__ == "__main__":
    sys.exit(main())
