"""bf16-storage capacity probe: demonstrate ``store_dtype=bfloat16``
doing the one job it claims — fitting problems f32 cannot — with a
measured datapoint at 100M+ pixels.

Uses C=K=16; the bf16 working set is half the f32 one:
(C + 3K) * N * dtype_bytes for the fused solve (Y + S in/out/new).

For each N in the ladder the probe attempts the fused PGM solve at f32
then bf16 (inputs generated directly in the storage dtype on device —
a capacity user would never stage a >HBM f32 copy), recording
ok / OOM / wall-clock / loss finiteness as one JSON line per attempt.
The headline datapoint is the first N where f32 OOMs and bf16 solves.

Run on a GPU:  python benchmarks/capacity_bf16.py [--N 100e6,150e6,200e6]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _classify(e):
    """(oom, message) from an exception: search the WHOLE message for
    the out-of-memory line and surface it, not the wrapper text."""
    msg = str(e)
    oom = ("RESOURCE_EXHAUSTED" in msg
           or "out of memory" in msg.lower()
           or "Ran out of memory" in msg)
    line = next((ln.strip() for ln in msg.splitlines()
                 if "Ran out of memory" in ln
                 or "RESOURCE_EXHAUSTED" in ln), None)
    return oom, (line[:300] if line else msg[:300])


def attempt(C, K, N, store_dtype, max_iter=10):
    import jax
    import jax.numpy as jnp
    import proxmin_tpu as pt
    import numpy as np

    dt = jnp.bfloat16 if store_dtype == "bf16" else jnp.float32
    # align N to the kernel tile so the runner's jnp.pad calls are
    # zero-width (XLA elides them instead of materializing a second
    # factor-sized copy — at this scale the pad copy alone is the
    # difference between fitting and OOM)
    N -= N % 8192

    # ---- placement probe FIRST: materialize the fused solve's peak
    # live set — S in + S_new out + Y, (2K + C) * N * itemsize —
    # directly on the device allocator, so an over-capacity attempt
    # fails with a genuine RESOURCE_EXHAUSTED before any compile.
    try:
        bufs = [jnp.zeros((K, N), dt), jnp.zeros((K, N), dt),
                jnp.zeros((C, N), dt)]
        jax.block_until_ready(bufs)
        del bufs
    except Exception as e:  # noqa: BLE001 — OOM classification
        oom, msg = _classify(e)
        return {"ok": False,
                "oom": oom,
                "stage": "placement",
                "working_set_gb": round((2 * K + C) * N
                                        * jnp.dtype(dt).itemsize / 1e9,
                                        1),
                "error": f"{type(e).__name__}: {msg}"}

    try:
        # generate on device in the storage dtype; uniform data keeps the
        # solve well-scaled without a >HBM ground-truth staging array
        kA, kS, kY = jax.random.split(jax.random.PRNGKey(0), 3)
        A = jax.random.uniform(kA, (C, K), jnp.float32)
        S = jax.random.uniform(kS, (K, N), dt)
        Y = jax.random.uniform(kY, (C, N), dt).astype(dt)
        jax.block_until_ready((A, S, Y))

        t0 = time.time()
        res = pt.nmf.nmf_pgm_fused(
            Y.astype(jnp.float32) if dt == jnp.float32 else Y,
            A,
            S.astype(jnp.float32) if dt == jnp.float32 else S,
            e_rel=0, max_iter=max_iter,
            store_dtype=dt if dt == jnp.bfloat16 else None,
        )
        wall = time.time() - t0
        a = np.asarray(res.x[0])
        return {"ok": True, "wall_s": round(wall, 1),
                "iterations": res.iterations,
                "finite": bool(np.isfinite(a).all()),
                "loss": float(res.loss)}
    except Exception as e:  # noqa: BLE001 — OOM classification
        oom, msg = _classify(e)
        return {"ok": False, "oom": oom,
                "error": f"{type(e).__name__}: {msg}"}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--N", default="100e6,150e6,200e6")
    ap.add_argument("--C", type=int, default=16)
    ap.add_argument("--K", type=int, default=16)
    ap.add_argument("--max-iter", type=int, default=10)
    args = ap.parse_args(argv)

    import subprocess

    for N_s in args.N.split(","):
        N = int(float(N_s))
        for dtype in ("f32", "bf16"):
            # each attempt in a fresh process: an OOM can poison the
            # allocator state for subsequent attempts in-process
            code = (
                "import sys, json; sys.path.insert(0, '/root/repo'); "
                "from benchmarks.capacity_bf16 import attempt; "
                f"print(json.dumps(attempt({args.C}, {args.K}, {N}, "
                f"'{dtype}', {args.max_iter})))"
            )
            try:
                r = subprocess.run([sys.executable, "-c", code],
                                   capture_output=True, text=True,
                                   timeout=1200)
                line = r.stdout.strip().splitlines()[-1] if r.stdout \
                    else json.dumps({"ok": False,
                                     "error": r.stderr[-200:]})
            except subprocess.TimeoutExpired:
                line = json.dumps({"ok": False, "error": "timeout"})
            row = json.loads(line)
            row.update({"N": N, "C": args.C, "K": args.K,
                        "store_dtype": dtype})
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
