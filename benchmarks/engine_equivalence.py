"""Engine-equivalence study: converged-quality across nmf() engines.

``engine='auto'`` silently swaps numerics-different engines (the XLA
drivers, the fused Pallas PGM kernels, the fused proximal-Adam kernel
with f32 or bf16 moment storage). The contract it inherits from the
reference is the fixed-point stopping rule
(``/root/reference/proxmin/algorithms.py:130-133``): *same tolerance =>
same converged quality, possibly a different path*. Mid-trajectory
iterates are intrinsically engine-sensitive, so the only
measurable form of the contract is distributional: over many seeds, each
engine's (a) iterations-to-tolerance and (b) final loss AT its own
convergence must come from matching distributions.

This study measures exactly that. For each configuration (placed at the
auto-router's measured decision boundaries, ``nmf.py:296-335``, so the
data covers where routing actually swaps engines) it runs every
eligible engine to ACTUAL convergence at a reference tolerance
(``e_rel`` 1e-4 small / 1e-3 flagship) over ``--seeds`` seeds, computes
the final loss with an engine-neutral float64 NumPy oracle, and checks
the ACCEPTANCE bound that ``engine='auto'`` promises:

- convergence-rate parity: each engine converges on (almost) the same
  fraction of seeds as the XLA baseline;
- iteration parity: median iterations-to-tolerance within a small ratio
  of the baseline's;
- quality parity: median final loss within the baseline's cross-seed
  spread (with a small relative floor for degenerate zero-spread cases).

``tests/test_engine_equivalence.py`` enforces the same bound at CPU
scale (interpret-mode kernels) on every CI run. The device-scale
configurations need a CUDA GPU (the fused kernels compile only there).

Usage::

    python benchmarks/engine_equivalence.py --seeds 50 \
        --out chiprun_out/engine_equiv.json
    python benchmarks/engine_equivalence.py --configs adaprox --seeds 8
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# --------------------------------------------------------------------------
# Acceptance bound: what engine="auto" promises (checked in CI at CPU
# scale, measured at device scale here), with ~2x margin over the worst
# value observed when the bound was set.

ACCEPTANCE = {
    # |conv_rate(engine) - conv_rate(xla)| <= this
    "conv_rate_tol": 0.10,
    # median iters(engine)/iters(xla) within [1/r, r]
    "iter_ratio": 1.30,
    # |med_loss(E) - med_loss(B)| <= max(margin * spread, frac * |med_B|)
    # where spread = max of the two engines' (q90 - q10) loss spreads
    "loss_spread_margin": 1.0,
    "loss_frac_floor": 0.01,
}


# --------------------------------------------------------------------------
# Problem generation (engine-neutral, NumPy host side)

def config_proxs(cfg):
    """The prox pair for a study configuration. ``unity_A`` is the
    reference unmixing anchor (``/root/reference/examples/unmixing.py:
    93-175``): rows of A projected onto the simplex, which breaks the
    A<->S scale symmetry so random-init problems reach the fixed-point
    tolerance (measured: 1794 iterations at seed 1000 on CPU f32 and on
    an H100 under the matmul-precision policy — identical to the
    reference implementation). ``plain`` is non-negativity only
    (separable, so every adaprox engine is eligible)."""
    from functools import partial

    from proxmin_tpu import operators as op

    if cfg.get("prox", "unity_A") == "unity_A":
        return partial(op.prox_unity_plus, axis=1), op.prox_plus
    return op.prox_plus, op.prox_plus


def make_problem(C, K, N, seed, weighted=False, planted=False,
                 noise=0.02, dtype=np.float32):
    """Planted NMF problem. ``planted=True`` initializes near the truth
    (multiplicative 0.7-1.3 perturbation) so flagship-scale instances
    reach the fixed-point tolerance in a bounded iteration budget;
    random init (the hard nonconvex case) is used at sizes where it
    converges (see bench.py's note: 1e6-px random init does not reach
    e_rel=1e-3 within 3000 iterations for ANY implementation of this
    math, reference included)."""
    rng = np.random.default_rng(seed)
    A_true = rng.random((C, K)).astype(dtype)
    S_true = rng.random((K, N)).astype(dtype)
    Y = (A_true @ S_true
         + noise * rng.standard_normal((C, N))).astype(dtype)
    if planted:
        A0 = (A_true * rng.uniform(0.7, 1.3, (C, K))).astype(dtype)
        S0 = (S_true * rng.uniform(0.7, 1.3, (K, N))).astype(dtype)
    else:
        A0 = rng.random((C, K)).astype(dtype)
        S0 = rng.random((K, N)).astype(dtype)
    W = (0.5 + rng.random((C, N))).astype(dtype) if weighted else None
    return Y, A0, S0, W


def loss_f64(A, S, Y, W=None):
    """Engine-neutral final-loss oracle: the reference Gaussian loss
    ``sum(W (Y - A S)^2) / 2`` (reference ``nmf.py:13-25``) in host
    float64, so engine-internal accumulation order cannot bias the
    quality comparison."""
    A = np.asarray(A, np.float64)
    S = np.asarray(S, np.float64)
    R = np.asarray(Y, np.float64) - A @ S
    R2 = R * R
    if W is not None:
        R2 = np.asarray(W, np.float64) * R2
    return 0.5 * float(R2.sum())


# --------------------------------------------------------------------------
# Configurations: each sits inside or outside the region where
# engine="auto" picks the fused kernels (nmf._fused_kernel_wins), so the
# distributions cover both engines on both sides of the choice.

GPU_CONFIGS = {
    # wide factor plane (C*K = 512): outside the kernels' region. Random
    # init (converges at this size), reference unmixing tolerance.
    "pgm-unw-c64": dict(
        C=64, K=8, N=16384, weighted=False, planted=False,
        prox="unity_A", algorithm=None, e_rel=1e-4, max_iter=12000,
        engines={
            "xla": dict(engine="xla"),
            "pallas": dict(engine="pallas"),
        },
    ),
    # many pixels at C*K = 128: just outside the region. Planted init
    # (see make_problem).
    "pgm-unw-cliff": dict(
        C=16, K=8, N=1_600_000, weighted=False, planted=True,
        prox="unity_A", algorithm=None, e_rel=1e-3, max_iter=6000,
        engines={
            "xla": dict(engine="xla"),
            "pallas": dict(engine="pallas"),
        },
    ),
    # Weighted adaptive flagship: inside the region.
    "pgm-w-adapt": dict(
        C=5, K=7, N=1_000_000, weighted=True, planted=True,
        prox="unity_A", algorithm=None, e_rel=1e-3, max_iter=6000,
        engines={
            "xla": dict(engine="xla", step_stride=10, step_adapt=True),
            "pallas": dict(engine="pallas", step_stride=10,
                           step_adapt=True),
        },
    ),
    # AdaProx: all four engine x moment-precision corners.
    "adaprox": dict(
        C=16, K=8, N=16384, weighted=False, planted=False,
        prox="plain", algorithm="adaprox", e_rel=1e-4, max_iter=12000,
        engines={
            "xla": dict(engine="xla", separable_prox="auto"),
            "xla-bf16m": dict(engine="xla", separable_prox="auto",
                              moment_dtype="bfloat16"),
            "pallas-f32": dict(engine="pallas", separable_prox="auto"),
            "pallas-bf16m": dict(engine="pallas", separable_prox="auto",
                                 moment_dtype="bfloat16"),
        },
    ),
}

# CPU-scale mirror of the same boundaries (interpret-mode kernels):
# shapes small enough for CI, same engine sets, same acceptance bound.
CPU_CONFIGS = {
    "pgm-unw": dict(
        C=16, K=4, N=512, weighted=False, planted=False,
        prox="unity_A", algorithm=None, e_rel=1e-4, max_iter=12000,
        engines={
            "xla": dict(engine="xla"),
            "pallas": dict(engine="pallas", tile_n=256),
        },
    ),
    # C=5/K=7: K is off a power of two, so the kernel's zero-padded K
    # rows meet prox_unity's sums. Mirrors the device config's factor
    # shape exactly.
    "pgm-w-adapt": dict(
        C=5, K=7, N=512, weighted=True, planted=False,
        prox="unity_A", algorithm=None, e_rel=1e-4, max_iter=12000,
        engines={
            "xla": dict(engine="xla", step_stride=10, step_adapt=True),
            "pallas": dict(engine="pallas", step_stride=10,
                           step_adapt=True, tile_n=256),
        },
    ),
    "adaprox": dict(
        C=16, K=4, N=512, weighted=False, planted=False,
        prox="plain", algorithm="adaprox", e_rel=1e-4, max_iter=12000,
        engines={
            "xla": dict(engine="xla", separable_prox="auto"),
            "pallas-f32": dict(engine="pallas", separable_prox="auto",
                               tile_n=256),
            "pallas-bf16m": dict(engine="pallas", separable_prox="auto",
                                 moment_dtype="bfloat16", tile_n=256),
        },
    ),
}


# --------------------------------------------------------------------------
# Running

def run_one(cfg, engine_kwargs, problem):
    """One (engine, seed) solve to convergence. Returns the per-seed
    record dict."""
    import jax.numpy as jnp

    import proxmin_tpu as pt

    Y, A0, S0, W = problem
    kw = dict(engine_kwargs)
    mdt = kw.pop("moment_dtype", None)
    if mdt is not None:
        kw["moment_dtype"] = jnp.dtype(mdt)
    prox_A, prox_S = config_proxs(cfg)
    t0 = time.perf_counter()
    res = pt.nmf.nmf(
        jnp.asarray(Y), jnp.asarray(A0), jnp.asarray(S0),
        W=jnp.asarray(W) if W is not None else 1,
        prox_A=prox_A, prox_S=prox_S,
        algorithm=cfg["algorithm"], e_rel=cfg["e_rel"],
        max_iter=cfg["max_iter"], **kw,
    )
    wall = time.perf_counter() - t0
    A_f, S_f = (np.asarray(x) for x in res.x)
    return {
        "iterations": int(res.iterations),
        "converged": bool(all(res.converged)),
        "status": res.status,
        "loss": loss_f64(A_f, S_f, Y, W),
        "wall_s": round(wall, 3),
    }


def run_config(name, cfg, seeds, log=print, rows_path=None):
    """All engines x all seeds for one configuration. One compile per
    engine (shapes are static across seeds).

    ``rows_path``: optional JSONL checkpoint. Completed (engine, seed)
    records are appended as they finish and skipped on re-run, so a
    watchdog can kill a wedged run and restart without repeating
    finished solves."""
    done = {}
    if rows_path and os.path.exists(rows_path):
        with open(rows_path) as f:
            for line in f:
                r = json.loads(line)
                if r.pop("config", name) == name:
                    done[(r.pop("engine"), r["seed"])] = r
        if done:
            log(f"  [{name}] resuming: {len(done)} records on disk")
    ckpt = open(rows_path, "a") if rows_path else None
    rows = {eng: [] for eng in cfg["engines"]}
    for i in range(seeds):
        seed = 1000 + i
        problem = None
        for eng, ekw in cfg["engines"].items():
            rec = done.get((eng, seed))
            if rec is None:
                if problem is None:
                    problem = make_problem(
                        cfg["C"], cfg["K"], cfg["N"], seed,
                        weighted=cfg["weighted"],
                        planted=cfg["planted"],
                    )
                rec = run_one(cfg, ekw, problem)
                rec["seed"] = seed
                if ckpt:
                    ckpt.write(json.dumps(
                        {"config": name, "engine": eng, **rec}) + "\n")
                    ckpt.flush()
            rows[eng].append(rec)
        log(f"  [{name}] seed {i + 1}/{seeds} done")
    if ckpt:
        ckpt.close()
    return rows


# --------------------------------------------------------------------------
# Statistics + acceptance

def _q(xs, q):
    return float(np.quantile(np.asarray(xs, np.float64), q))


def summarize(rows):
    """Distribution stats for one engine's per-seed records. Iteration
    and loss stats are over CONVERGED seeds (quality-at-convergence is
    the contract; the convergence-rate bound separately catches an
    engine that converges on different problems)."""
    conv = [r for r in rows if r["converged"]]
    out = {
        "n": len(rows),
        "n_converged": len(conv),
        "conv_rate": len(conv) / max(len(rows), 1),
    }
    if conv:
        its = [r["iterations"] for r in conv]
        ls = [r["loss"] for r in conv]
        out.update(
            iters_med=_q(its, 0.5), iters_q10=_q(its, 0.1),
            iters_q90=_q(its, 0.9),
            loss_med=_q(ls, 0.5), loss_q10=_q(ls, 0.1),
            loss_q90=_q(ls, 0.9),
        )
    return out


def check_equivalence(stats_by_engine, baseline, bound=ACCEPTANCE):
    """Apply the acceptance bound to every engine vs the baseline.
    Returns {engine: {check: {..., ok: bool}}} with an overall flag."""
    B = stats_by_engine[baseline]
    verdicts = {}
    for eng, E in stats_by_engine.items():
        if eng == baseline:
            continue
        checks = {}
        checks["conv_rate"] = {
            "engine": E["conv_rate"], "baseline": B["conv_rate"],
            "tol": bound["conv_rate_tol"],
            "ok": abs(E["conv_rate"] - B["conv_rate"])
            <= bound["conv_rate_tol"],
        }
        if E.get("iters_med") and B.get("iters_med"):
            ratio = E["iters_med"] / B["iters_med"]
            checks["iterations"] = {
                "ratio": round(ratio, 4), "bound": bound["iter_ratio"],
                "ok": 1 / bound["iter_ratio"] <= ratio
                <= bound["iter_ratio"],
            }
            spread = max(B["loss_q90"] - B["loss_q10"],
                         E["loss_q90"] - E["loss_q10"])
            tol = max(bound["loss_spread_margin"] * spread,
                      bound["loss_frac_floor"] * abs(B["loss_med"]))
            diff = abs(E["loss_med"] - B["loss_med"])
            checks["loss"] = {
                "median_diff": diff, "tol": tol,
                "rel_diff": round(diff / max(abs(B["loss_med"]), 1e-30),
                                  6),
                "ok": diff <= tol,
            }
        else:
            # no converged seeds on one side: only acceptable if the
            # conv-rate check already failed (it will have)
            checks["iterations"] = {"ok": False,
                                    "note": "no converged seeds"}
            checks["loss"] = {"ok": False, "note": "no converged seeds"}
        verdicts[eng] = {
            "checks": checks,
            "ok": all(c["ok"] for c in checks.values()),
        }
    return verdicts


def run_study(configs, seeds, log=print, rows_path=None):
    """Full study: per-config engine distributions + acceptance
    verdicts. Returns the results dict (JSON-serializable)."""
    results = {"seeds": seeds, "acceptance": ACCEPTANCE, "configs": {}}
    for name, cfg in configs.items():
        log(f"config {name}: C={cfg['C']} K={cfg['K']} N={cfg['N']} "
            f"weighted={cfg['weighted']} planted={cfg['planted']} "
            f"e_rel={cfg['e_rel']} engines={list(cfg['engines'])}")
        rows = run_config(name, cfg, seeds, log=log,
                          rows_path=rows_path)
        stats = {eng: summarize(r) for eng, r in rows.items()}
        baseline = "xla"
        verdicts = check_equivalence(stats, baseline)
        for eng, st in stats.items():
            log(f"  {name}/{eng}: conv {st['n_converged']}/{st['n']}"
                + (f", iters med {st['iters_med']:.0f} "
                   f"[{st['iters_q10']:.0f}, {st['iters_q90']:.0f}], "
                   f"loss med {st['loss_med']:.6g} "
                   f"[{st['loss_q10']:.6g}, {st['loss_q90']:.6g}]"
                   if st.get("iters_med") else ""))
        for eng, v in verdicts.items():
            log(f"  {name}/{eng} vs {baseline}: "
                + ("EQUIVALENT" if v["ok"] else "NOT EQUIVALENT")
                + f" {json.dumps(v['checks'], default=float)[:300]}")
        results["configs"][name] = {
            "problem": {k: cfg.get(k) for k in
                        ("C", "K", "N", "weighted", "planted", "prox",
                         "e_rel", "max_iter", "algorithm")},
            "rows": rows,
            "stats": stats,
            "verdicts": {e: v for e, v in verdicts.items()},
            "all_ok": all(v["ok"] for v in verdicts.values()),
        }
    results["all_ok"] = all(c["all_ok"]
                            for c in results["configs"].values())
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=50)
    ap.add_argument("--configs", nargs="*", default=None,
                    help="subset of config names (default: all)")
    ap.add_argument("--cpu", action="store_true",
                    help="use the CPU-scale config set")
    ap.add_argument("--out", default=None, help="write JSON here")
    ap.add_argument("--rows-log", default=None,
                    help="JSONL checkpoint: per-seed records appended "
                         "as they finish; completed records are "
                         "skipped on re-run (watchdog-restart safe)")
    args = ap.parse_args()

    if args.cpu:
        # CPU backend, fused kernels in Pallas's interpreter
        import jax

        from proxmin_tpu.ops import nmf_kernels

        jax.config.update("jax_platforms", "cpu")
        nmf_kernels.INTERPRET = True

    table = CPU_CONFIGS if args.cpu else GPU_CONFIGS
    if args.configs:
        unknown = set(args.configs) - set(table)
        if unknown:
            sys.exit(f"unknown configs: {sorted(unknown)} "
                     f"(have {sorted(table)})")
        table = {k: table[k] for k in args.configs}

    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    from proxmin_tpu.utils import summarize_convergence_warnings

    t0 = time.perf_counter()
    with summarize_convergence_warnings():
        results = run_study(table, args.seeds, log=log,
                            rows_path=args.rows_log)
    results["wall_s"] = round(time.perf_counter() - t0, 1)
    log(f"total {results['wall_s']} s; all_ok={results['all_ok']}")
    payload = json.dumps(results, default=float)
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload)
        log(f"wrote {args.out}")
    else:
        print(payload)


if __name__ == "__main__":
    main()
