"""Sharded NMF: pixel-axis data parallelism (+ optional channel tensor
parallelism) with explicit XLA collectives.

Two complementary paths:

* **auto path** — :func:`shard_nmf_problem` lays out Y/S/W with the pixel
  axis sharded and A replicated, then the ordinary jitted solvers from
  ``proxmin_tpu.algorithms`` run unchanged: XLA's SPMD partitioner
  propagates the shardings through the ``lax.while_loop`` and inserts the
  ``psum`` for the ``D @ S^T`` contraction automatically.
* **explicit path** — :func:`make_nmf_pgm_step` /:func:`nmf_pgm_sharded`
  build the training step with ``shard_map`` and hand-written collectives
  (the scaling-book recipe), which pins the communication pattern:

      D_l      = W_l * (A S_l - Y_l)            local
      grad_A   = psum_data(D_l S_l^T)           one (C,K) all-reduce
      grad_S_l = A^T D_l                        local
      ||S||^2  = lambda_max(psum_data(S_l S_l^T))   K×K, replicated
      ||A||^2  = lambda_max(A^T A)              local (A replicated)

  With a 2-D mesh ('data', 'model') the channel axis of Y and A also
  shards: grad_S then needs a second psum over 'model', giving true
  TP×DP. Convergence scalars are psum'd so every shard agrees and the
  while-loop condition stays consistent device-side.

No hand-written NCCL/MPI calls: collectives are XLA's (NCCL on GPUs),
laid out by the mesh, which follows the algorithm alone — every GPU of a
host reaches every other at the same rate (reference has no distribution
at all — SURVEY.md §2 checklist).
"""

import logging
import math
from typing import Any, NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from .. import operators
from ..precision import (
    RESIDUAL_PRECISION,
    STREAM_PRECISION,
    TINY_PRECISION,
)
from ..utils import with_matmul_precision
from ..solvers.common import SolverResult

logger = logging.getLogger("proxmin")

__all__ = [
    "make_mesh",
    "shard_nmf_problem",
    "make_nmf_pgm_step",
    "nmf_pgm_sharded",
    "prox_unity_sharded",
    "hlo_collectives",
]

_COLLECTIVE_RE = None


def hlo_collectives(hlo_text):
    """Extract every collective op from an optimized-HLO dump.

    Returns ``[(op, [member_element_counts])]`` — one entry per
    collective instruction (``all-gather`` / ``all-reduce`` /
    ``reduce-scatter`` / ``collective-permute`` / ``all-to-all``,
    sync or ``-start`` async forms), with the element count of every
    member of its (possibly tuple-typed) result shape. XLA may merge
    several small reductions into one tuple-shaped all-reduce, so a
    single entry can carry several members.

    This is the auditing primitive behind the collective-layout test
    suite (``tests/test_collective_layout.py``) and the pod-scaling
    harness (``benchmarks/pod_scaling.py``): compile your sharded
    computation with ``jax.jit(fn).lower(*args).compile().as_text()``
    and assert the pattern you designed for — e.g. for the pixel-
    sharded NMF solves, nothing but small all-reduces (the (C,K)
    gradient contraction, Grams, and convergence scalars; reference
    anchor ``proxmin/nmf.py:39-41``).
    """
    global _COLLECTIVE_RE
    if _COLLECTIVE_RE is None:
        import re

        _COLLECTIVE_RE = (
            re.compile(
                r"= ([^=\n]*?)\b"
                r"(all-gather|all-reduce|reduce-scatter|"
                r"collective-permute|all-to-all)"
                r"(?:-start)?\("
            ),
            re.compile(r"\w+\[([0-9,]*)\]"),
        )
    op_re, shape_re = _COLLECTIVE_RE
    out = []
    for m in op_re.finditer(hlo_text):
        shapes, op = m.group(1), m.group(2)
        sizes = [
            int(np.prod([int(d) for d in dims.split(",")])) if dims else 1
            for dims in shape_re.findall(shapes)
        ]
        out.append((op, sizes if sizes else [1]))
    return out


def make_mesh(shape=None, axis_names=None, devices=None):
    """Build a :class:`jax.sharding.Mesh`.

    Defaults: all visible devices on a 1-D ``('data',)`` mesh. Pass
    ``shape=(d, m)`` with ``axis_names=('data', 'model')`` for 2-D
    DP×TP layouts.
    """
    if devices is None:
        devices = jax.devices()
    if shape is None:
        shape = (len(devices),)
    if axis_names is None:
        axis_names = ("data",) if len(shape) == 1 else ("data", "model")
    n = math.prod(shape)
    assert n <= len(devices), f"mesh needs {n} devices, have {len(devices)}"
    dev_array = np.asarray(devices[:n]).reshape(shape)
    return Mesh(dev_array, axis_names)


def _axis_size(mesh, axis):
    """Device count along one mesh axis or a tuple of axes (tuples give
    multi-level sharding, e.g. ``("host", "data")`` for the standard
    multi-host layout: pixel shards split across hosts first, within a
    host second)."""
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return math.prod(mesh.shape[a] for a in axis)
    return mesh.shape[axis]


def shard_nmf_problem(mesh, Y, A, S, W=None, data_axis="data",
                      model_axis=None):
    """Place an NMF problem on a mesh: Y/S/W sharded along the pixel axis,
    A replicated (or channel-sharded over ``model_axis``).

    ``data_axis`` may be a tuple of mesh axes for multi-level sharding
    (e.g. ``("host", "data")`` across hosts).

    Returns ``(Y, A, S, W)`` as device arrays with NamedShardings; the
    ordinary solvers then run sharded (auto-SPMD path).
    """
    from ..solvers.common import promote_dtype_host

    # half/integer inputs promote to the default float dtype, matching
    # the single-device solver boundary (the sharded while-loops carry
    # float-promoted scalars too); host arrays stay host-side (see
    # _put: no default-backend commitment)
    Y, A, S = (promote_dtype_host(Y), promote_dtype_host(A),
               promote_dtype_host(S))
    if W is not None:
        W = promote_dtype_host(W)
    n_data = _axis_size(mesh, data_axis)
    N = np.shape(Y)[1]
    if N % n_data != 0:
        raise ValueError(
            f"pixel axis N={N} must be divisible by the '{data_axis}' mesh "
            f"axis ({n_data} devices); pad Y/S/W along the pixel axis "
            f"(e.g. with zero-weight pixels) to a multiple of {n_data}"
        )
    if model_axis is not None:
        n_model = _axis_size(mesh, model_axis)
        C = np.shape(Y)[0]
        if C % n_model != 0:
            raise ValueError(
                f"channel axis C={C} must be divisible by the "
                f"'{model_axis}' mesh axis ({n_model} devices)"
            )
    y_spec = P(model_axis, data_axis)
    a_spec = P(model_axis, None)
    s_spec = P(None, data_axis)
    Y = _put(Y, NamedSharding(mesh, y_spec))
    A = _put(A, NamedSharding(mesh, a_spec))
    S = _put(S, NamedSharding(mesh, s_spec))
    if W is not None and hasattr(W, "shape") and getattr(W, "ndim", 0) == 2:
        W = _put(W, NamedSharding(mesh, y_spec))
    return Y, A, S, W


def _classify_weight(W, y_shape):
    """Normalize a weight argument for the sharded whole-solves:
    ``(weighted, W2d)``.

    ``None`` and the scalar 1 (the reference's ``W == 1`` convention,
    ``nmf._is_unweighted``) are unweighted. Any OTHER scalar or
    lower-rank W is *weighted* — it broadcasts against Y exactly like
    the single-device engines' ``_promote_W`` — and comes back as a
    zero-copy host view the caller materializes shard-by-shard. (A
    scalar ``W=0.5`` previously fell through the old ``ndim == 2``
    test and was silently dropped, so the mesh route solved a
    different problem than the single-device path.) 2-D W passes
    through untouched.
    """
    if W is None:
        return False, None
    if np.isscalar(W) or getattr(W, "ndim", None) == 0:
        if float(W) == 1.0:
            return False, None
        return True, np.broadcast_to(np.asarray(W), tuple(y_shape))
    if getattr(W, "ndim", None) == 2:
        return True, W
    return True, np.broadcast_to(np.asarray(W), tuple(y_shape))


def _weight_shard(W_native, W2, Y, mesh, data_axis, model_axis,
                  weighted):
    """The W operand for a sharded whole-solve.

    Unweighted: the builders never read W (``D = R``), so alias Y
    rather than materializing a Y-sized all-ones plane — at capacity
    scales that plane alone (C·N·4 bytes) is the difference between
    fitting and OOM. ``export.py``'s artifacts already use this
    dead-operand contract. Weighted with a broadcast view (scalar /
    lower-rank W): materialize shard-by-shard on host, never whole."""
    if not weighted:
        return Y
    if W_native is not None:
        return W_native
    sh = NamedSharding(mesh, P(model_axis, data_axis))
    np_dt = np.dtype(Y.dtype)
    return jax.make_array_from_callback(
        Y.shape, sh,
        lambda idx: np.ascontiguousarray(W2[idx]).astype(np_dt))


def _put(x, sharding):
    """``device_put`` straight from host memory to the target sharding.

    Host inputs go through ``np.asarray`` (no device commitment), NOT
    ``jnp.asarray``: the latter first commits the array to the *default*
    backend, which forces a cross-backend transfer when the mesh lives on
    a different platform (e.g. a virtual CPU mesh while the default
    backend is a TPU) — and can fail outright when that backend is
    unavailable. jax.Arrays are passed through as-is."""
    if not isinstance(x, jax.Array):
        x = np.asarray(x)
    return jax.device_put(x, sharding)


def prox_unity_sharded(X, step, axis=0, axis_name=None):
    """Sum-to-one projection when the normalization axis is sharded:
    the local sum is completed by a ``psum`` over ``axis_name``."""
    s = jnp.sum(X, axis=axis, keepdims=True)
    if axis_name is not None:
        s = jax.lax.psum(s, axis_name)
    return X / s


def _lambda_max_small(G, iters=32):
    """Power iteration on a small PSD matrix (K×K)."""
    k = G.shape[0]
    v = jnp.ones((k,), G.dtype) + 0.01 * jnp.arange(k, dtype=G.dtype)
    v = v / jnp.linalg.norm(v)
    # inherit G's varying-manual-axes type so the fori_loop carry is
    # consistent when G is device-varying inside shard_map
    v = v + 0.0 * G[0]

    def body(_, v):
        w = jnp.dot(G, v, precision=TINY_PRECISION)
        return w / jnp.maximum(jnp.linalg.norm(w), jnp.finfo(G.dtype).tiny)

    v = jax.lax.fori_loop(0, iters, body, v)
    return (v @ jnp.dot(G, v, precision=TINY_PRECISION)) / (v @ v)


def _weighted_steps_v0(A, S, dt):
    """Cold-start iterate for the sharded batched power iteration (the
    shard-local slice of the single-device cold start)."""
    K_ = A.shape[1]
    v = jnp.ones((S.shape[1], K_), dt) + 0.01 * jnp.arange(K_, dtype=dt)
    v = v + 0.0 * S.T  # inherit device-varying type
    return v / jnp.linalg.norm(v, axis=1, keepdims=True)


def _weighted_steps(A, S, W, data_axis, model_axis, dt, num_iters=48,
                    v0=None, return_v=False):
    """Weighted Lipschitz step sizes assembled with collectives:
    ``1 / max_c lmax(S diag(W_c) S^T)`` (psum over data, pmax over model)
    and ``1 / max_n lmax(A^T diag(W_n) A)`` via implicit batched power
    iteration (an (N_local, K) iterate — never (N, K, K)). Fully-masked
    pixels/channels contribute a 0 block, not NaN.

    ``v0``/``return_v``: optional warm-start iterate carried between
    strided refreshes (see ``nmf.WeightedPGMStepper``) — the per-pixel
    iterations are shard-local, so warm starting is collective-free on
    1-D meshes (each pass psums only over ``model_axis`` if present)."""
    H_A = jax.lax.psum(jnp.einsum("kn,cn,ln->ckl", S, W, S,
                                  precision=STREAM_PRECISION), data_axis)
    LA = jnp.max(jax.vmap(_lambda_max_small)(H_A))
    if model_axis is not None:
        LA = jax.lax.pmax(LA, model_axis)

    def Hv_S(v):
        t = jnp.einsum("nk,ck->cn", v, A, precision=STREAM_PRECISION)
        u = W * t
        hv = jnp.einsum("cn,ck->nk", u, A, precision=STREAM_PRECISION)
        if model_axis is not None:
            hv = jax.lax.psum(hv, model_axis)
        return hv

    v = _weighted_steps_v0(A, S, dt) if v0 is None else v0
    tiny = jnp.finfo(dt).tiny

    def normalize(w):
        ssq = jnp.sum(w * w, axis=1, keepdims=True)
        return w * jax.lax.rsqrt(jnp.maximum(ssq, tiny))

    def pow_body(_, v):
        return normalize(Hv_S(v))

    v = jax.lax.fori_loop(0, num_iters, pow_body, v)
    hv = Hv_S(v)
    rayleigh = jnp.sum(v * hv, axis=1) / jnp.maximum(
        jnp.sum(v * v, axis=1), tiny)
    LS = jax.lax.pmax(jnp.max(rayleigh), data_axis)
    if return_v:
        return 1.0 / LA, 1.0 / LS, normalize(hv)
    return 1.0 / LA, 1.0 / LS


def _unweighted_steps(A, S, data_axis, model_axis):
    """Unweighted Lipschitz steps: K×K Grams with one psum each."""
    SSt = jax.lax.psum(jnp.dot(S, S.T, precision=STREAM_PRECISION),
                       data_axis)
    AtA = jnp.dot(A.T, A, precision=TINY_PRECISION)
    if model_axis is not None:
        AtA = jax.lax.psum(AtA, model_axis)
    return 1.0 / _lambda_max_small(SSt), 1.0 / _lambda_max_small(AtA)


def make_nmf_pgm_step(mesh, prox_A=operators.prox_plus,
                      prox_S=operators.prox_plus, weighted=False,
                      data_axis="data", model_axis=None):
    """Build the explicitly-collective PGM-NMF training step.

    Returns a jitted function ``step(A, S, Y, W?) -> (A', S', loss)``
    operating on globally-sharded arrays via ``shard_map`` with the
    collective layout described in the module docstring. ``prox_S`` runs on
    the local pixel shard — if it normalizes along the pixel axis use
    :func:`prox_unity_sharded` with ``axis_name=data_axis``.
    """
    y_spec = P(model_axis, data_axis)
    a_spec = P(model_axis, None)
    s_spec = P(None, data_axis)
    scalar_spec = P()

    def local_step(A, S, Y, W):
        dt = jnp.result_type(A, S)
        R = jnp.dot(A, S, preferred_element_type=dt,
                            precision=RESIDUAL_PRECISION) - Y
        D = (W * R) if weighted else R

        grad_A = jax.lax.psum(
            jnp.dot(D, S.T, preferred_element_type=dt,
                            precision=STREAM_PRECISION), data_axis
        )
        grad_S = jnp.dot(A.T, D, preferred_element_type=dt,
                            precision=STREAM_PRECISION)
        if model_axis is not None:
            grad_S = jax.lax.psum(grad_S, model_axis)

        if weighted:
            step_A, step_S = _weighted_steps(A, S, W, data_axis,
                                             model_axis, dt)
        else:
            step_A, step_S = _unweighted_steps(A, S, data_axis, model_axis)

        A_new = prox_A(A - step_A * grad_A, step_A)
        S_new = prox_S(S - step_S * grad_S, step_S)

        # loss = sum(W R^2)/2 = sum(D R)/2 (reduces to sum(R^2)/2 unweighted)
        loss = jax.lax.psum(jnp.sum(D * R) / 2, data_axis)
        if model_axis is not None:
            loss = jax.lax.psum(loss, model_axis)
        return A_new, S_new, loss

    smapped = shard_map(
        local_step, mesh=mesh,
        in_specs=(a_spec, s_spec, y_spec, y_spec),
        out_specs=(a_spec, s_spec, scalar_spec),
    )

    @jax.jit
    def step(A, S, Y, W=None):
        if W is None:
            W = jnp.ones_like(Y)
        return smapped(A, S, Y, W)

    return step


_STRIDE_SAFETY = 0.9   # strided-refresh shrink; growth budget = (1-s)/2


class ShardedNMFState(NamedTuple):
    A: Any
    S: Any
    step_A: Any
    step_S: Any
    it: Any
    conv_A: Any
    conv_S: Any
    loss: Any


def _build_pgm_solve(mesh, weighted, prox_A, prox_S, e_rel, max_iter,
                     data_axis, model_axis, step_stride, step_adapt,
                     resume=False):
    """Build the jitted whole-solve ``(A0, S0, Y, W) -> (A, S, it,
    conv_A, conv_S, loss)`` shard_map for :func:`nmf_pgm_sharded`.

    ``resume=True`` builds the exact-warm-restart variant: the solve
    additionally takes the carried iteration clock (and, in segmented
    strided mode, the frozen step scalars, the refresh interval, the
    segment boundary, and — weighted — the sharded power iterate), first
    finishes the interrupted segment with the carried steps, then
    re-enters the normal refresh loop; in strided mode those carries are
    also returned so the next continuation resumes exactly too.

    Exposed separately so the collective-layout audit
    (``tests/test_collective_layout.py``) can lower/compile the exact
    production computation and assert on its optimized-HLO collectives
    without running a solve."""
    y_spec = P(model_axis, data_axis)
    a_spec = P(model_axis, None)
    s_spec = P(None, data_axis)
    strided = (step_stride is not None and step_stride > 1) or step_adapt

    def all_sum(v, *axes):
        for ax in axes:
            if ax is not None:
                v = jax.lax.psum(v, ax)
        return v

    def local_solve(A, S, Y, W, *rargs):
        dt = jnp.result_type(A, S)
        if resume:
            if strided and weighted:
                (it0, convA0, convS0, loss0,
                 sA0, sS0, stride_r, seg_end0, v0r) = rargs
            elif strided:
                (it0, convA0, convS0, loss0,
                 sA0, sS0, stride_r, seg_end0) = rargs
            else:
                it0, convA0, convS0, loss0 = rargs
            it0 = jnp.asarray(it0, jnp.int32)
            convA0 = jnp.asarray(convA0, bool)
            convS0 = jnp.asarray(convS0, bool)
            loss0 = jnp.asarray(loss0, dt)
            it_lim = it0 + max_iter
        else:
            it0 = jnp.int32(0)
            convA0 = convS0 = jnp.asarray(False)
            loss0 = jnp.asarray(jnp.inf, dt)
            it_lim = max_iter

        def compute_steps(A, S):
            if weighted:
                return _weighted_steps(A, S, W, data_axis, model_axis, dt)
            return _unweighted_steps(A, S, data_axis, model_axis)

        def make_body(frozen_steps=None):
            """One PGM iteration; ``frozen_steps`` (segmented strided
            mode) skips the in-body step computation entirely."""

            def body(state):
                A, S = state.A, state.S
                R = jnp.dot(A, S, preferred_element_type=dt,
                            precision=RESIDUAL_PRECISION) - Y
                D = W * R if weighted else R

                grad_A = all_sum(
                    jnp.dot(D, S.T, preferred_element_type=dt,
                            precision=STREAM_PRECISION), data_axis
                )
                grad_S = all_sum(
                    jnp.dot(A.T, D, preferred_element_type=dt,
                            precision=STREAM_PRECISION), model_axis
                )

                if frozen_steps is not None:
                    step_A, step_S = frozen_steps
                else:
                    step_A, step_S = compute_steps(A, S)

                A_new = prox_A(A - step_A * grad_A, step_A)
                S_new = prox_S(S - step_S * grad_S, step_S)

                # fixed-point convergence, reduced across every mesh axis
                dA = all_sum(jnp.sum((A_new - A) ** 2), model_axis)
                nA = all_sum(jnp.sum(A_new ** 2), model_axis)
                dS = all_sum(jnp.sum((S_new - S) ** 2), data_axis,
                             model_axis)
                nS = all_sum(jnp.sum(S_new ** 2), data_axis, model_axis)
                # sum(W R^2)/2 == sum(D R)/2 (= sum(R^2)/2 unweighted)
                loss = all_sum(jnp.sum(D * R) / 2, data_axis, model_axis)
                # failure detection: poison the (pre-update) loss from
                # the post-update norms, so the cond's isfinite stop
                # fires the same iteration the iterate diverges (see
                # nmf._poison_loss — same rule, replicated scalars)
                finite = jnp.logical_and(
                    jnp.logical_and(jnp.isfinite(dA), jnp.isfinite(nA)),
                    jnp.logical_and(jnp.isfinite(dS), jnp.isfinite(nS)))
                loss = jnp.where(finite, loss, jnp.nan)

                return ShardedNMFState(
                    A=A_new, S=S_new,
                    step_A=jnp.asarray(step_A, dt),
                    step_S=jnp.asarray(step_S, dt),
                    it=state.it + 1,
                    conv_A=dA <= e_rel ** 2 * nA,
                    conv_S=dS <= e_rel ** 2 * nS,
                    loss=loss,
                )

            return body

        def cond(state):
            done = jnp.logical_and(state.conv_A, state.conv_S)
            # failure detection: the psum'd loss covers every live
            # quantity, so a non-finite value after >=1 iteration of
            # this call means a diverged iterate (init loss is inf by
            # design on FRESH solves, hence the it > it0 guard; resumed
            # solves carry the real last loss, so a poisoned nan carry
            # keeps a diverged solve stopped — it0 > 0. The replicated
            # scalar keeps every shard stopping on the same iteration.)
            bad = jnp.logical_and(
                jnp.logical_not(jnp.isfinite(state.loss)),
                jnp.logical_or(state.it > it0, it0 > 0))
            return jnp.logical_and(
                state.it < it_lim,
                jnp.logical_not(jnp.logical_or(done, bad)))

        init = ShardedNMFState(
            A=A, S=S,
            step_A=(jnp.asarray(sA0, dt) if resume and strided
                    else jnp.zeros((), dt)),
            step_S=(jnp.asarray(sS0, dt) if resume and strided
                    else jnp.zeros((), dt)),
            it=it0,
            # terminal flags carry on resume: a solve that already
            # stopped (converged or diverged) stays stopped
            conv_A=convA0, conv_S=convS0,
            loss=loss0,
        )

        if strided:
            # segmented strided mode (same architecture as the pgm
            # driver's _run_segmented): refresh the steps once per
            # stride OUTSIDE the hot inner loop, with the weighted power
            # iterate warm-started across refreshes (cold 48 passes on
            # the first, 12 after) — the refresh branch and its
            # (N_local, K) iterate stay out of the inner carry. Every
            # shard takes the same outer iteration count (it and the
            # convergence scalars are replicated), so the collectives
            # inside the refresh stay collective-safe.
            # the warm-start iterate exists only on weighted solves (an
            # unweighted carry would thread a dead (N_local, K) array
            # through every segment boundary)
            if resume:
                v0 = v0r if weighted else ()
                stride0 = jnp.asarray(stride_r, jnp.int32)
                seg0 = jnp.asarray(seg_end0, jnp.int32)
                # finish the interrupted segment with the carried frozen
                # steps before any refresh — the continuation walks the
                # exact iterations the uninterrupted solve would have
                init = jax.lax.while_loop(
                    lambda s2: jnp.logical_and(cond(s2), s2.it < seg0),
                    make_body((init.step_A, init.step_S)), init)
            else:
                v0 = _weighted_steps_v0(A, S, dt) if weighted else ()
                stride0 = jnp.int32(step_stride if step_stride else 1)
                seg0 = it0

            def outer_cond(carry):
                return cond(carry[0])

            def outer_body(carry):
                st, v, stride_c, _ = carry
                if weighted:
                    # dynamic trip count, not a cond over two fori_loops
                    # (the cond branches compile poorly-fused)
                    sA, sS, v = _weighted_steps(
                        st.A, st.S, W, data_axis, model_axis, dt,
                        num_iters=jnp.where(st.it == 0, 48, 12),
                        v0=v, return_v=True)
                else:
                    sA, sS = _unweighted_steps(st.A, st.S, data_axis,
                                               model_axis)
                steps = (_STRIDE_SAFETY * jnp.asarray(sA, dt),
                         _STRIDE_SAFETY * jnp.asarray(sS, dt))
                if step_adapt:
                    # drift vs the previously-carried (replicated) step
                    # scalars; the first refresh (zero-initialized
                    # steps) pins the stride via first=
                    from ..utils import grow_stride

                    stride_c = grow_stride(
                        stride_c, (st.step_A, st.step_S), steps,
                        (1.0 - _STRIDE_SAFETY) / 2, 100,
                        first=(st.it == 0))
                st = st._replace(step_A=steps[0], step_S=steps[1])
                seg_end = st.it + (stride_c if step_adapt
                                   else step_stride)

                def inner_cond(s2):
                    return jnp.logical_and(cond(s2), s2.it < seg_end)

                st = jax.lax.while_loop(inner_cond, make_body(steps), st)
                return st, v, stride_c, seg_end

            final, v_f, stride_f, seg_f = jax.lax.while_loop(
                outer_cond, outer_body, (init, v0, stride0, seg0))
            outs = (final.A, final.S, final.it, final.conv_A,
                    final.conv_S, final.loss, final.step_A, final.step_S,
                    stride_f, seg_f) + ((v_f,) if weighted else ())
        else:
            final = jax.lax.while_loop(cond, make_body(), init)
            outs = (final.A, final.S, final.it, final.conv_A,
                    final.conv_S, final.loss)
        return outs

    in_specs = (a_spec, s_spec, y_spec, y_spec)
    out_specs = (a_spec, s_spec, P(), P(), P(), P())
    if resume:
        # it0 + terminal scalars (conv_A, conv_S, loss), then the
        # strided step carries
        in_specs += (P(), P(), P(), P()) \
            + ((P(), P(), P(), P()) if strided else ())
        if strided and weighted:
            in_specs += (P(data_axis, None),)
    if strided:
        out_specs += (P(), P(), P(), P())
        if weighted:
            out_specs += (P(data_axis, None),)
    smapped = shard_map(
        local_solve, mesh=mesh,
        in_specs=in_specs, out_specs=out_specs,
    )
    return jax.jit(smapped)


class ShardedAdaproxState(NamedTuple):
    A: Any
    S: Any
    MA: Any              # Adam moments, sharded like their block
    VA: Any
    MS: Any
    VS: Any
    it: Any
    conv_A: Any
    conv_S: Any
    loss: Any


def _build_adaprox_solve(mesh, weighted, prox_A, prox_S, e_rel,
                         max_iter, data_axis, model_axis, b1, b2, eps,
                         resume=False):
    """Build the jitted whole-solve shard_map for
    :func:`nmf_adaprox_sharded` (VERDICT r4 #5): the proximal-Adam
    analogue of :func:`_build_pgm_solve`, with explicit hand-placed
    collectives instead of trusting the auto-SPMD partitioner.

    Iteration math mirrors the single-chip engines exactly
    (``solvers/adaprox.py`` adam phi/psi + the separable closed-form
    prox; ``nmf._make_fused_adaprox_runner``): ``step_adaprox`` row
    means (reference ``nmf.py:91-93``), moment EMAs with
    bias-corrected Phi/Psi, ``x - alpha * Phi/Psi`` then
    ``prox(x, alpha/Psi)``. Collective layout:

    - ``alpha_A``: C-axis mean -> one tiny (K,) psum over *model*;
    - ``alpha_S``: N-axis mean -> one (K, 1) psum over *data*;
    - ``grad_A = D S^T``: (C_l, K) psum over *data* (the one
      pixel-axis contraction — identical to the PGM layout, so the
      comm-volume table in docs/DESIGN.md applies unchanged);
    - ``grad_S = A^T D``: (K, N_l) psum over *model* (2-D meshes);
    - convergence norms / loss: replicated scalars psum'd over every
      axis, so all shards stop on the same iteration.

    The moments live in the carry sharded exactly like their blocks
    (MA/VA as A, MS/VS as S) — they never cross the network.

    ``resume=True`` additionally takes ``(it0, conv_A0, conv_S0,
    loss0, MA0, VA0, MS0, VS0)`` and continues the global Adam
    bias-correction clock bit-exactly; the moments are always
    returned so every call's ``.state`` can resume."""
    y_spec = P(model_axis, data_axis)
    a_spec = P(model_axis, None)
    s_spec = P(None, data_axis)
    tiny = float(np.finfo(np.float32).tiny)

    def all_sum(v, *axes):
        for ax in axes:
            if ax is not None:
                v = jax.lax.psum(v, ax)
        return v

    def local_solve(A, S, Y, W, *rargs):
        dt = jnp.result_type(A, S)
        C = all_sum(jnp.asarray(A.shape[0], dt), model_axis)
        N = all_sum(jnp.asarray(S.shape[1], dt), data_axis)
        if resume:
            it0_in, convA0, convS0, loss0, MA0, VA0, MS0, VS0 = rargs
            it0 = jnp.asarray(it0_in, jnp.int32)
            convA0 = jnp.asarray(convA0, bool)
            convS0 = jnp.asarray(convS0, bool)
            loss0 = jnp.asarray(loss0, dt)
            it_lim = it0 + max_iter
        else:
            it0 = jnp.int32(0)
            convA0 = convS0 = jnp.asarray(False)
            loss0 = jnp.asarray(jnp.inf, dt)
            it_lim = max_iter
            MA0 = jnp.zeros_like(A)
            VA0 = jnp.zeros_like(A)
            MS0 = jnp.zeros_like(S)
            VS0 = jnp.zeros_like(S)

        b1_t = jnp.asarray(b1, dt)
        b2_t = jnp.asarray(b2, dt)

        def body(st):
            A, S = st.A, st.S
            t = (st.it + 1).astype(dt)  # global Adam clock (resume-safe)
            bc1 = 1.0 / (1.0 - b1_t ** t)
            bc2 = 1.0 / (1.0 - b2_t ** t)

            # step_adaprox (reference nmf.py:91-93), mesh-reduced
            alpha_A = all_sum(jnp.sum(A, axis=0), model_axis) / C / 10.0
            alpha_S = all_sum(jnp.sum(S, axis=1, keepdims=True),
                              data_axis) / N / 10.0

            R = jnp.dot(A, S, preferred_element_type=dt,
                        precision=RESIDUAL_PRECISION) - Y
            D = W * R if weighted else R
            gA = all_sum(jnp.dot(D, S.T, preferred_element_type=dt,
                                 precision=STREAM_PRECISION), data_axis)
            gS = all_sum(jnp.dot(A.T, D, preferred_element_type=dt,
                                 precision=STREAM_PRECISION), model_axis)

            def adam_block(x, g, M, V, alpha, prox):
                M1 = (1.0 - b1_t) * g + b1_t * M
                V1 = (1.0 - b2_t) * g ** 2 + b2_t * V
                Phi = M1 * bc1
                Psi = jnp.sqrt(V1 * bc2) + eps
                Psi_safe = jnp.maximum(Psi, tiny)
                x1 = x - alpha * Phi / Psi_safe
                x1 = prox(x1, alpha / Psi_safe)
                return x1, M1, V1

            A1, MA1, VA1 = adam_block(A, gA, st.MA, st.VA,
                                      alpha_A[None, :], prox_A)
            S1, MS1, VS1 = adam_block(S, gS, st.MS, st.VS,
                                      alpha_S, prox_S)

            dA = all_sum(jnp.sum((A1 - A) ** 2), model_axis)
            nA = all_sum(jnp.sum(A1 ** 2), model_axis)
            dS = all_sum(jnp.sum((S1 - S) ** 2), data_axis, model_axis)
            nS = all_sum(jnp.sum(S1 ** 2), data_axis, model_axis)
            loss = all_sum(jnp.sum(D * R) / 2, data_axis, model_axis)
            finite = jnp.logical_and(
                jnp.logical_and(jnp.isfinite(dA), jnp.isfinite(nA)),
                jnp.logical_and(jnp.isfinite(dS), jnp.isfinite(nS)))
            loss = jnp.where(finite, loss, jnp.nan)

            return ShardedAdaproxState(
                A=A1, S=S1, MA=MA1, VA=VA1, MS=MS1, VS=VS1,
                it=st.it + 1,
                conv_A=dA <= e_rel ** 2 * nA,
                conv_S=dS <= e_rel ** 2 * nS,
                loss=loss,
            )

        def cond(st):
            done = jnp.logical_and(st.conv_A, st.conv_S)
            bad = jnp.logical_and(
                jnp.logical_not(jnp.isfinite(st.loss)),
                jnp.logical_or(st.it > it0, it0 > 0))
            return jnp.logical_and(
                st.it < it_lim,
                jnp.logical_not(jnp.logical_or(done, bad)))

        init = ShardedAdaproxState(
            A=A, S=S, MA=MA0, VA=VA0, MS=MS0, VS=VS0,
            it=it0, conv_A=convA0, conv_S=convS0, loss=loss0,
        )
        f = jax.lax.while_loop(cond, body, init)
        return (f.A, f.S, f.it, f.conv_A, f.conv_S, f.loss,
                f.MA, f.VA, f.MS, f.VS)

    in_specs = (a_spec, s_spec, y_spec, y_spec)
    if resume:
        in_specs += (P(), P(), P(), P(),
                     a_spec, a_spec, s_spec, s_spec)
    out_specs = (a_spec, s_spec, P(), P(), P(), P(),
                 a_spec, a_spec, s_spec, s_spec)
    smapped = shard_map(
        local_solve, mesh=mesh,
        in_specs=in_specs, out_specs=out_specs,
    )
    return jax.jit(smapped)


@with_matmul_precision
def nmf_adaprox_sharded(
    Y, A, S, W=None, mesh=None,
    prox_A=operators.prox_plus, prox_S=operators.prox_plus,
    e_rel=1e-3, max_iter=1000,
    data_axis="data", model_axis=None,
    b1=0.9, b2=0.999, eps=1e-8,
    state=None,
):
    """Full sharded proximal-Adam NMF solve with explicit collectives
    (the adaprox sibling of :func:`nmf_pgm_sharded`; VERDICT r4 #5 —
    the live ``nmf(mesh=, algorithm='adaprox')`` path no longer
    depends on the auto-SPMD partitioner's layout choice).

    Supported configuration mirrors the fused single-chip engine:
    ``scheme='adam'`` with SEPARABLE proxs applied in closed form
    (non-separable proxs and the other five schemes stay on the
    audited auto-SPMD route through ``nmf()``). ``state=`` is the
    exact warm restart: moments, the global Adam bias-correction
    clock, and the terminal flags carry through bit-exactly.

    Returns a ``SolverResult`` with ``.x == (A, S)`` (sharded device
    arrays), ``.iterations``, ``.converged``, ``.loss``, ``.state``.
    """
    if mesh is None:
        mesh = make_mesh()
    weighted, W2 = _classify_weight(W, np.shape(Y))
    if state is not None:
        if not (hasattr(state, "get")
                and state.get("kind") == "nmf_adaprox_sharded"):
            raise ValueError(
                "state= must be a previous nmf_adaprox_sharded .state "
                "dict (single-device adaprox states do not resume the "
                "explicit-collective path)"
            )
        if bool(state["weighted"]) != weighted:
            raise ValueError(
                "state= was produced under a different weighting"
            )
    Y, A0, S0, W_sh = shard_nmf_problem(
        mesh, Y, A, S, W2 if (weighted and W2 is W) else None,
        data_axis=data_axis, model_axis=model_axis,
    )
    W_sh = _weight_shard(W_sh, W2, Y, mesh, data_axis, model_axis,
                         weighted)

    solve = _build_adaprox_solve(
        mesh, weighted, prox_A or operators.prox_id,
        prox_S or operators.prox_id, e_rel, max_iter,
        data_axis, model_axis, b1, b2, eps,
        resume=state is not None,
    )
    rargs = ()
    if state is not None:
        rargs = (jnp.int32(state["it"]),
                 jnp.asarray(state.get("conv_A", False), bool),
                 jnp.asarray(state.get("conv_S", False), bool),
                 jnp.asarray(state.get("loss", 0.0)),
                 state["MA"], state["VA"], state["MS"], state["VS"])
    A_f, S_f, it, cA, cS, loss, MA, VA, MS, VS = solve(
        A0, S0, Y, W_sh, *rargs)
    loss = float(loss)
    resume_state = {
        "kind": "nmf_adaprox_sharded", "weighted": weighted, "it": it,
        "conv_A": bool(cA), "conv_S": bool(cS), "loss": loss,
        "MA": MA, "VA": VA, "MS": MS, "VS": VS,
    }
    it0 = int(state["it"]) if state is not None else 0
    converged = (bool(cA), bool(cS))
    iterations = int(it) - it0
    diverged = not np.isfinite(loss) and (iterations > 0 or it0 > 0)
    from ..solvers.common import status_from, writeback

    status = status_from(all(converged), diverged, logger)
    writeback((A, S), (A_f, S_f))
    return SolverResult(
        converged,
        x=(A_f, S_f), iterations=iterations, converged=converged,
        loss=loss, status=status, state=resume_state,
    )


@with_matmul_precision
def nmf_pgm_sharded(
    Y, A, S, W=None, mesh=None,
    prox_A=operators.prox_plus, prox_S=operators.prox_plus,
    e_rel=1e-3, max_iter=1000,
    data_axis="data", model_axis=None,
    step_stride=None,
    step_adapt=False,
    state=None,
):
    """Full sharded PGM-NMF solve: the entire while-loop runs inside one
    jitted ``shard_map`` over the mesh — convergence scalars are psum'd so
    all shards agree and the loop never leaves the devices.

    Semantics match ``proxmin_tpu.nmf.nmf`` with ``algorithm='pgm'``
    (unweighted or weighted Gaussian model, per-factor fixed-point
    convergence at ``e_rel``); layout matches :func:`make_nmf_pgm_step`.
    ``step_stride`` recomputes the Lipschitz bounds only every this many
    iterations (0.9 safety factor, like ``nmf(step_stride=...)``) — on
    weighted problems the bounds cost ~50 collective-completed passes
    per evaluation, so striding them matters even more when each pass
    also crosses devices. ``step_adapt=True`` grows the refresh interval
    in-carry (the ApproximateCache rule, ``utils.grow_stride``) — the
    interval is derived from psum-replicated step scalars, so every
    shard takes identical segment lengths and the collectives inside
    the refresh stay collective-safe.

    ``state=`` is the exact warm restart for preempted multi-device
    solves:
    pass a previous call's ``.state`` (same weighting / stride
    configuration) together with its final iterates and the
    continuation reproduces the uninterrupted trajectory exactly —
    the iteration clock, and in strided mode the frozen step scalars,
    the refresh interval, the segment boundary, and the sharded
    power-iteration warm start all carry through (and round-trip
    through ``proxmin_tpu.checkpoint``). ``max_iter`` counts the
    additional iterations of this call.

    Returns a ``SolverResult`` with ``.x == (A, S)`` (sharded device
    arrays), ``.iterations``, ``.converged``, ``.loss``, ``.state``.
    """
    if mesh is None:
        mesh = make_mesh()
    weighted, W2 = _classify_weight(W, np.shape(Y))
    strided = (step_stride is not None and step_stride > 1) or step_adapt
    stride_cfg = (0 if step_stride is None else int(step_stride),
                  bool(step_adapt))
    if state is not None:
        if not (hasattr(state, "get")
                and state.get("kind") == "nmf_pgm_sharded"):
            raise ValueError(
                "state= must be a previous nmf_pgm_sharded .state dict "
                "(single-device solver states do not resume the "
                "explicit-collective path)"
            )
        st_cfg = tuple(state.get("stride_config", stride_cfg))
        if (bool(state["strided"]) != strided
                or (int(st_cfg[0]), bool(st_cfg[1])) != stride_cfg):
            raise ValueError(
                "state= was produced under a different stride "
                "configuration (step_stride={}, step_adapt={} vs this "
                "call's step_stride={}, step_adapt={}); resume with "
                "the same settings — the carried segment boundaries "
                "and refresh schedule are only exact under them".format(
                    st_cfg[0] or None, bool(st_cfg[1]),
                    step_stride, step_adapt)
            )
        if bool(state["weighted"]) != weighted:
            raise ValueError(
                "state= was produced under a different weighting (the "
                "carried step scalars and power iterate would be wrong)"
            )
    Y, A0, S0, W_sh = shard_nmf_problem(
        mesh, Y, A, S, W2 if (weighted and W2 is W) else None,
        data_axis=data_axis, model_axis=model_axis,
    )
    W_sh = _weight_shard(W_sh, W2, Y, mesh, data_axis, model_axis,
                         weighted)

    solve = _build_pgm_solve(mesh, weighted, prox_A, prox_S, e_rel,
                             max_iter, data_axis, model_axis,
                             step_stride, step_adapt,
                             resume=state is not None)
    rargs = ()
    if state is not None:
        # terminal scalars (absent on pre-r4-final checkpoints: default
        # "not stopped"/finite loss): a stopped solve stays stopped
        rargs = (jnp.int32(state["it"]),
                 jnp.asarray(state.get("conv_A", False), bool),
                 jnp.asarray(state.get("conv_S", False), bool),
                 jnp.asarray(state.get("loss", 0.0)))
        if strided:
            rargs += (state["step_A"], state["step_S"],
                      jnp.int32(state["stride"]),
                      jnp.int32(state["seg_end"]))
            if weighted:
                rargs += (jnp.asarray(state["v"]),)
    outs = solve(A0, S0, Y, W_sh, *rargs)
    A_f, S_f, it, cA, cS, loss = outs[:6]
    loss = float(loss)
    resume_state = {
        "kind": "nmf_pgm_sharded", "strided": strided,
        "weighted": weighted, "it": it,
        "stride_config": stride_cfg,
        "conv_A": bool(cA), "conv_S": bool(cS), "loss": loss,
    }
    if strided:
        resume_state.update(
            step_A=outs[6], step_S=outs[7], stride=outs[8],
            seg_end=outs[9])
        if weighted:
            resume_state["v"] = outs[10]

    it0 = int(state["it"]) if state is not None else 0
    converged = (bool(cA), bool(cS))
    iterations = int(it) - it0
    # a resumed solve carries its (possibly nan-poisoned) loss, so a
    # diverged-then-resumed no-op stays "diverged"
    diverged = not np.isfinite(loss) and (iterations > 0 or it0 > 0)
    from ..solvers.common import status_from, writeback

    status = status_from(all(converged), diverged, logger)
    writeback((A, S), (A_f, S_f))
    return SolverResult(
        converged,
        x=(A_f, S_f), iterations=iterations, converged=converged,
        loss=loss, status=status, state=resume_state,
    )
