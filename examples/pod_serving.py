"""Multi-chip serving — export once, serve anywhere (even preempted).

The production-serving story for multi-device solves, end to end:

1. EXPORT the explicit-collective sharded whole-solve as a StableHLO
   artifact (`export_nmf_pgm_sharded`): fixed mesh topology, runtime
   ``max_iter``, pinned collective layout (one (C,K) psum/iteration).
2. SERVE it with plain ``jax.export.deserialize`` — no proxmin_tpu in
   the serving process; inputs committed to the recorded layout.
3. PREEMPT mid-solve, and CONTINUE through the ``resume=True`` artifact
   (strided artifacts return their step carries): the continuation
   reproduces the uninterrupted trajectory bit-exactly.

Works on real multi-chip meshes and on the virtual CPU mesh::

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/pod_serving.py --cpu
"""

import os as _os
import sys as _sys

_sys.path.insert(
    0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import sys

import numpy as np


def main():
    import jax

    if "--cpu" in sys.argv:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    from jax import export as jax_export
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from proxmin_tpu.export import export_nmf_pgm_sharded
    from proxmin_tpu.parallel import make_mesh, nmf_pgm_sharded

    n_dev = jax.device_count()
    print(f"devices: {n_dev} x {jax.devices()[0].platform}")

    rng = np.random.default_rng(11)
    C, K = 6, 4
    N = 4096 * n_dev
    A_true = rng.random((C, K)).astype(np.float32)
    S_true = rng.random((K, N)).astype(np.float32)
    Y = (A_true @ S_true + 0.01 * rng.standard_normal((C, N))).astype(
        np.float32)
    W = (0.5 + rng.random((C, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)

    mesh = make_mesh()
    kw = dict(e_rel=0.0, weighted=True, step_stride=8)

    # 1. export: one fresh artifact + one continuation artifact
    fresh_blob = export_nmf_pgm_sharded(mesh, C, K, N, **kw)
    cont_blob = export_nmf_pgm_sharded(mesh, C, K, N, resume=True, **kw)
    print(f"artifacts: fresh {len(fresh_blob)//1024} KiB, "
          f"resume {len(cont_blob)//1024} KiB")

    # 2. serve: plain jax.export — commit inputs to the recorded layout
    fresh = jax_export.deserialize(fresh_blob).call
    cont = jax_export.deserialize(cont_blob).call
    put = lambda x, s: jax.device_put(  # noqa: E731
        jnp.asarray(x), NamedSharding(mesh, s))
    rep = lambda v: jax.device_put(v, NamedSharding(mesh, P()))  # noqa: E731
    A_d = put(A0, P(None, None))
    S_d = put(S0, P(None, "data"))
    Y_d = put(Y, P(None, "data"))
    W_d = put(W, P(None, "data"))

    # 3. "preemption": 30 iterations, then the job goes away...
    outs = fresh(A_d, S_d, Y_d, W_d, rep(jnp.int32(30)))
    A_m, S_m, it = outs[0], outs[1], outs[2]
    print(f"preempted at it={int(it)}, loss={float(outs[5]):.4f}")

    # ...continuation on a (here: the same) mesh via the resume
    # artifact: the carries are exactly the fresh artifact's outputs
    # from position 2 on — (it, conv_A, conv_S, loss, step_A, step_S,
    # stride, seg_end) replicated, plus the pixel-sharded v
    outs2 = cont(A_m, S_m, Y_d, W_d, rep(jnp.int32(45)),
                 *(rep(o) for o in outs[2:-1]), outs[-1])
    print(f"resumed to it={int(outs2[2])}, loss={float(outs2[5]):.4f}")

    # the uninterrupted live solve walks the identical trajectory
    ref = nmf_pgm_sharded(Y, A0.copy(), S0.copy(), W=W, mesh=mesh,
                          e_rel=0, max_iter=75, step_stride=8)
    dS = float(np.max(np.abs(np.asarray(outs2[1]) - np.asarray(ref.x[1]))))
    print(f"max |S_artifact - S_live_uninterrupted| = {dS:.2e}")
    assert dS == 0.0, "artifact continuation must be bit-exact"
    print("artifact-served, preempted, resumed — bit-exact vs live")


if __name__ == "__main__":
    main()
