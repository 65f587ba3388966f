"""Constrained matrix factorization (NMF/CMF) — the flagship application.

Accelerator re-design of the reference ``proxmin/nmf.py``: solves
``min 0.5 * || sqrt(W) . (Y - A S) ||^2`` under arbitrary proximal
constraints per factor, by dispatching to the jit-compiled solver drivers.

Key changes vs the reference:

* **Gradients are two matmuls** against the residual
  ``D = W * (A S - Y)`` (same math as reference ``nmf.py:39-41``), fused by
  XLA with the weighting and the prox epilogue; hand-fused Pallas kernels
  that run a whole iteration in one pass over ``Y`` live in
  ``proxmin_tpu.ops``.
* **Lipschitz step sizes never touch the host.** Unweighted: the spectral
  norms ``||S||_s^2 = lambda_max(S S^T)`` and ``||A||_s^2`` are tiny K×K
  symmetric eigenproblems solved on device. Weighted: the reference
  materializes CN×CK / CK×CN sparse block matrices and runs
  ``scipy.sparse.linalg.eigs`` **per iteration** (``nmf.py:69-88``, its
  worst scaling behavior); here the same block-diagonal spectral norms
  (``max_c lambda_max(S diag(W_c) S^T)`` and
  ``max_n lambda_max(A^T diag(W_n) A)`` — block-diag spectral norm = max
  over blocks) are computed on device: the C channel blocks exactly (one
  einsum pass + eigvalsh on the tiny K×K Grams), the N pixel blocks by
  implicit batched power iteration — never materializing anything bigger
  than the factors themselves.
* **Pixel-axis sharding**: with a ``jax.sharding.Mesh``, ``Y``/``S``/``W``
  shard over the pixel axis N and the tiny ``A`` replicates; the
  ``D @ S^T`` contraction over N becomes an all-reduce inserted by XLA
  (see ``proxmin_tpu.parallel``).
"""

import functools
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from . import algorithms, operators, utils
from .precision import (
    RESIDUAL_PRECISION,
    STREAM_PRECISION,
    TINY_PRECISION,
)
from .ops import nmf_kernels
from .ops.nmf_kernels import cuda_available, pixel_tile
from .solvers.common import asarray_cached

import logging

logger = logging.getLogger("proxmin")

__all__ = [
    "log_likelihood",
    "grad_likelihood",
    "step_A",
    "step_S",
    "step_pgm",
    "step_adaprox",
    "pgm_nmf_iteration",
    "nmf",
    "nmf_pgm_fused",
    "nmf_adaprox_fused",
]


def log_likelihood(*X, Y=0, W=1):
    """Gaussian NMF log-likelihood ``sum(W * (Y - A S)^2) / 2``
    (reference ``nmf.py:13-25``)."""
    A, S = X
    R = Y - jnp.dot(A, S, preferred_element_type=jnp.result_type(A, S),
                    precision=RESIDUAL_PRECISION)
    return jnp.sum(W * R ** 2) / 2


def grad_likelihood(*X, Y=0, W=1):
    """Gradient of :func:`log_likelihood` w.r.t. (A, S): with
    ``D = W * (A S - Y)``, returns ``(D S^T, A^T D)``
    (reference ``nmf.py:28-41``)."""
    A, S = X
    dt = jnp.result_type(A, S)
    # precision per dot class (see precision.py): the K-axis product A S
    # is absolute-error-critical (a reduced-precision product stalls or
    # shifts the fixed-point test); the pixel-axis contractions are
    # relative-error ops
    D = W * (jnp.dot(A, S, preferred_element_type=dt,
                     precision=RESIDUAL_PRECISION) - Y)
    return (
        jnp.dot(D, S.T, preferred_element_type=dt,
                precision=STREAM_PRECISION),
        jnp.dot(A.T, D, preferred_element_type=dt,
                precision=STREAM_PRECISION),
    )


def _lambda_max(G):
    """Largest eigenvalue of a small symmetric PSD matrix (K×K, on device)."""
    return jnp.linalg.eigvalsh(G)[-1]


def step_A(A, S):
    """``1 / ||S^T||_s^2 = 1 / lambda_max(S S^T)`` (reference ``nmf.py:44-45``)."""
    return 1.0 / _lambda_max(jnp.dot(S, S.T, precision=STREAM_PRECISION))


def step_S(A, S):
    """``1 / ||A||_s^2 = 1 / lambda_max(A^T A)`` (reference ``nmf.py:48-49``)."""
    return 1.0 / _lambda_max(jnp.dot(A.T, A, precision=TINY_PRECISION))


def _lam_max_psd_batch(H, iters):
    """Max top-eigenvalue over a stack of tiny PSD Grams ``(C, K, K)``
    by batched power iteration — pure matvec/elementwise ops, so it
    composes with ``jax.vmap`` (batched ``eigvalsh`` is a poor fit for
    vmap on accelerators). Used by :func:`functional.make_nmf_solver`'s
    weighted path; the host drivers use the exact ``eigvalsh`` route in
    :func:`_weighted_lipschitz_A` instead."""
    c, k, _ = H.shape
    u = jnp.ones((c, k), H.dtype) + 0.01 * jnp.arange(k, dtype=H.dtype)

    def body(_, u):
        w = jnp.einsum("ckl,cl->ck", H, u, precision=TINY_PRECISION)
        ssq = jnp.sum(w * w, axis=1, keepdims=True)
        return w * jax.lax.rsqrt(jnp.maximum(ssq,
                                             jnp.finfo(H.dtype).tiny))

    u = jax.lax.fori_loop(0, iters, body, u)
    hu = jnp.einsum("ckl,cl->ck", H, u, precision=TINY_PRECISION)
    ray = jnp.sum(u * hu, axis=1) / jnp.maximum(
        jnp.sum(u * u, axis=1), jnp.finfo(H.dtype).tiny)
    return jnp.max(ray)


def _weighted_lipschitz_A(S, W):
    """``max_c lambda_max(S diag(W[c,:]) S^T)``.

    Mathematically identical to the reference's
    ``||PS^T Sigma^-1 PS||_s`` with the CK×CK block-diagonal matrix
    (``nmf.py:69-77``): the spectral norm of a block-diagonal operator is
    the max over the per-channel K×K blocks. The C Gram blocks are tiny
    (K×K), so they are assembled exactly in ONE pass over W/S (an
    einsum) and eigensolved on device — the round-1 48-pass batched
    power iteration paid 48x the HBM traffic for an approximation.
    Falls back to batched Lanczos for unusually large C*K*K. The
    vmap-safe power-iteration variant over the same Grams is
    :func:`_lam_max_psd_batch`."""
    C = W.shape[0]
    K = S.shape[0]
    dtype = jnp.result_type(S, W)
    if C * K * K <= (1 << 20):
        H = jnp.einsum("kn,cn,ln->ckl", S, W, S,
                       precision=STREAM_PRECISION)
        return jnp.max(jnp.linalg.eigvalsh(H)[:, -1])

    v0 = jnp.ones((C, K), dtype) + 0.01 * jnp.arange(K, dtype=dtype)
    v0 = v0 / jnp.linalg.norm(v0, axis=1, keepdims=True)

    def Hv(v):
        t = jnp.einsum("ck,kn->cn", v, S, precision=STREAM_PRECISION)
        u = W * t
        return jnp.einsum("cn,kn->ck", u, S,
                          precision=STREAM_PRECISION)

    return jnp.max(utils.batched_lanczos_max(Hv, v0, min(K, 32) + 2))


def _weighted_lipschitz_S_v0(N, K, dtype):
    """The deterministic cold-start iterate for the batched power
    iteration (shared by the one-shot and warm-started paths)."""
    v = jnp.ones((N, K), dtype) + 0.01 * jnp.arange(K, dtype=dtype)
    return v / jnp.linalg.norm(v, axis=1, keepdims=True)


def _weighted_lipschitz_S(A, W, num_iters=48, v0=None, return_v=False):
    """``max_n lambda_max(A^T diag(W[:,n]) A)`` by batched implicit power
    iteration (the per-pixel blocks of the reference's CN×CN block
    eigenproblem, ``nmf.py:79-85``).

    ``v0``: optional warm-start iterate ``(N, K)`` — e.g. the previous
    refresh's ``v`` when A drifts slowly between strided step refreshes;
    a warm start needs ~4x fewer passes for the same accuracy (each pass
    reads W and does ~140 FLOPs per pixel, so pass count is the whole
    cost). ``return_v`` additionally returns the final
    normalized iterate for the next warm start.

    Negative results from round 2, kept for the record: (a) a
    batched-Lanczos variant (min(C,K)+2 exact passes — see
    :func:`utils.batched_lanczos_max`) measured NO faster at the
    flagship shape: the per-pixel eigenvalue extraction (Sturm
    bisection / top-k refinement) adds sequential latency, and at 1e6
    pixels the Gershgorin candidate-selection bound binds ~17% above
    the true maximum, degrading the steps. Cold power iteration at 48
    passes measured within 0.1% of exact (per-pixel spectra are not
    pathologically clustered for generic weights). (b) An
    alternating-argmax scheme (``u <- top eigvec of the argmax pixel's
    Gram``, one W pass per outer iteration) is monotone but gets stuck
    in local maxima on near-orthogonal channel geometries (measured 3x
    underestimates) — an underestimated Lipschitz bound means divergent
    steps, so it is unusable."""
    N = W.shape[1]
    K = A.shape[1]
    dtype = jnp.result_type(A, W)
    v = _weighted_lipschitz_S_v0(N, K, dtype) if v0 is None else v0
    tiny = jnp.finfo(dtype).tiny

    def Hv(v):
        t = jnp.einsum("nk,ck->cn", v, A,
                       precision=STREAM_PRECISION)  # A v per pixel
        u = W * t                                    # diag(W_n) .
        return jnp.einsum("cn,ck->nk", u, A,
                          precision=STREAM_PRECISION)  # A^T .

    def normalize(w):
        # rsqrt of the row sum-of-squares fuses into the producing pass
        # (jnp.linalg.norm's sqrt-then-divide compiled to separate
        # reduce + divide fusions inside nested while/cond contexts)
        ssq = jnp.sum(w * w, axis=1, keepdims=True)
        return w * jax.lax.rsqrt(jnp.maximum(ssq, tiny))

    def body(_, v):
        return normalize(Hv(v))

    # num_iters may be a traced value (dynamic trip count): the warm-start
    # callers select cold/warm pass counts with jnp.where instead of a
    # lax.cond over two fori_loops, which compiled to separate poorly-
    # fused branch computations (measured 2.4x slower per pass in-driver)
    v = jax.lax.fori_loop(0, num_iters, body, v)
    # fully-masked pixels (W[:, n] == 0) give a 0 block, not NaN
    hv = Hv(v)
    rayleigh = jnp.sum(v * hv, axis=1) / jnp.maximum(
        jnp.sum(v * v, axis=1), tiny)
    lmax = jnp.max(rayleigh)
    if return_v:
        # hv is one more (free) power pass than v — return it normalized
        return lmax, normalize(hv)
    return lmax


def _promote_if_needed(a, keep=None):
    """Half/integer inputs -> default float dtype; float32/float64
    inputs (incl. NumPy arrays, whose object identity the in-place
    writeback contract relies on, and host arrays destined for mesh
    shardings) pass through untouched. ``keep``: a reduced storage
    dtype an already-matching plane may stay in (capacity mode)."""
    if np.isscalar(a):
        return a
    from .solvers.common import promote_dtype_host

    return promote_dtype_host(a, keep=keep)


def _is_unweighted(W):
    """True for the scalar 1 (Python, NumPy or JAX scalar; the reference's
    ``W == 1`` convention, ``nmf.py:64`` — which itself crashes for array
    W)."""
    if W is None:
        return True
    if np.isscalar(W) or getattr(W, "ndim", None) == 0:
        return float(W) == 1.0
    return False


def _promote_W(W, Y):
    """Materialize a weight argument as a full (C, N) device array:
    scalars fill, lower-rank arrays broadcast against Y (the XLA
    engine's ``W * (A S - Y)`` would broadcast implicitly; the fused
    kernels and the weighted Lipschitz math need the explicit 2-D
    form). One shared helper so the engines cannot drift."""
    Y = jnp.asarray(Y)
    if np.isscalar(W) or getattr(W, "ndim", None) == 0:
        return jnp.full(Y.shape, W, Y.dtype)
    from .solvers.common import promote_dtype

    # half/int weights -> float (every engine); keep=Y.dtype lets a W
    # already matching a reduced-storage Y skip the eager f32 round
    # trip (capacity mode: the f32 W transient alone can OOM)
    W = promote_dtype(W, keep=Y.dtype)
    if W.shape != Y.shape:
        return jnp.broadcast_to(W, Y.shape).astype(Y.dtype)
    return W.astype(Y.dtype)


def _fused_prox_safe(prox, block):
    """Can ``engine='auto'`` route this prox onto the fused PGM kernel?

    The kernel applies ``prox_S`` per pixel TILE (anything coupling
    pixels — e.g. ``prox_unity(axis=1)`` on S — would silently compute
    tile-local sums), and the kernel hands ``prox_S`` a block whose K
    axis is padded with zero rows to a power of two (sums are
    padding-invariant but arbitrary user callables may not be).
    Auto-routing therefore requires *known* library
    operators; everything else stays on the XLA engine. Explicit
    ``engine='pallas'`` keeps the documented trust-the-caller contract
    (``nmf_pgm_fused`` docstring).
    """
    if prox is None:
        return True
    kw = {}
    if isinstance(prox, functools.partial):
        if prox.args:  # positionally-bound step/thresh: be conservative
            return False
        kw = dict(prox.keywords)
        prox = prox.func
    if prox in (operators.prox_id, operators.prox_zero,
                operators.prox_plus, operators.prox_min,
                operators.prox_max, operators.prox_hard,
                operators.prox_hard_plus, operators.prox_soft,
                operators.prox_soft_plus, operators.prox_max_entropy):
        return True  # elementwise for every kwarg combination
    if prox in (operators.prox_unity, operators.prox_unity_plus):
        # A is proxed whole, so either axis is safe; S is proxed per
        # pixel tile (zero-padded K rows keep sums), so only the factor
        # axis (0) is tile-local — axis=1 would normalize per tile
        return True if block == "A" else kw.get("axis", 0) == 0
    if isinstance(prox, operators.AlternatingProjections):
        return all(_fused_prox_safe(p, block) for p in prox.operators)
    return False


def _fused_kernel_wins(C, K, N):
    """Shapes at which the fused kernels' runners measured faster than the
    XLA engine on an H100 (``chip_smoke.py`` phase (e); numbers in
    PERF.md, "Kernels on the H100"): small factor planes over many
    pixels. The kernel streams the channels of a tile one after another,
    so its time grows with C·K: it lost at C=188, K=12."""
    return C * K <= _KERNEL_MAX_CK and N >= _KERNEL_MIN_N


#: Bounds of the measured region of :func:`_fused_kernel_wins`: it covers
#: the flagship (C=5, K=7, N=1e6), where the kernels won, and stops well
#: short of C=188, K=12, N=47,500, where they lost.
_KERNEL_MAX_CK = 64
_KERNEL_MIN_N = 1 << 18


def _adaprox_separable_ok(prox_A, prox_S, mode):
    """True when every PRESENT prox has a known separable closed form
    under ``mode`` (the ``separable_prox`` kwarg) — the eligibility
    rule shared by the ``engine='auto'`` fused-adaprox check and the
    explicit sharded adaprox route. Returns False instead of raising
    on unknown proxs so routing sites can fall through to the
    XLA/auto-SPMD paths (the strict ``engine='pallas'`` entry
    re-derives the blocks itself so its errors reach the user)."""
    from .solvers.common import separable_blocks

    prox_pair = (prox_A, prox_S)
    has = tuple(pj is not None for pj in prox_pair)
    try:
        sep = separable_blocks(prox_pair, has, mode)
    except ValueError:
        return False
    return all(s or not h for s, h in zip(sep, has))


def step_pgm(*X, it=None, W=1):
    """Lipschitz PGM step sizes ``(step_A, step_S)`` for the Gaussian model
    (reference ``nmf.py:52-88``). Weighted case uses implicit batched power
    iteration instead of sparse host eigensolves — see module docstring."""
    A, S = X
    if _is_unweighted(W):
        return step_A(A, S), step_S(A, S)
    LA = _weighted_lipschitz_A(S, W)
    LS = _weighted_lipschitz_S(A, W)
    return 1.0 / LA, 1.0 / LS


class _WeightedStepperBase:
    """Shared machinery of the warm-started weighted-Lipschitz steppers:
    constructor fields, the driver data-split hook (W rides as a jit
    argument), structural cache keying, and the cold/warm dynamic trip
    count."""

    _cache_tag = None  # set by subclasses

    def __init__(self, W, stride=10, safety=0.9, cold_iters=48,
                 warm_iters=12, adapt=False, max_stride=100):
        self.W = W
        self.stride = int(stride)
        self.safety = float(safety)
        self.cold_iters = int(cold_iters)
        self.warm_iters = int(warm_iters)
        self.adapt = bool(adapt)
        self.max_stride = int(max_stride)

    def _refresh_iters(self, it):
        """Dynamic trip count: cold on the first refresh, warm after —
        NOT a lax.cond over two fori_loops, whose branches compile to
        separate poorly-fused computations inside the solver loop."""
        return jnp.where(it == 0, self.cold_iters, self.warm_iters)

    def split_data(self):
        """Driver hook: W rides as a jit argument, not a trace constant."""
        cls = type(self)
        stride, safety = self.stride, self.safety
        cold, warm = self.cold_iters, self.warm_iters
        adapt, max_stride = self.adapt, self.max_stride

        def rebuild(leaves):
            return cls(leaves[0], stride=stride, safety=safety,
                       cold_iters=cold, warm_iters=warm, adapt=adapt,
                       max_stride=max_stride)

        return rebuild, (jnp.asarray(self.W),)

    def stepper_cache_key(self):
        from .solvers.common import cacheable, value_key

        wk = value_key(self.W)
        if not cacheable(wk):
            return wk
        return (self._cache_tag, self.stride, self.safety,
                self.cold_iters, self.warm_iters, self.adapt,
                self.max_stride, wk)


class WeightedPGMStepper(_WeightedStepperBase):
    """Strided weighted-Lipschitz stepper with a warm-started power
    iterate carried in the solver state.

    The weighted bounds (reference ``nmf.py:69-88``) cost ~48 power
    passes over W per refresh from a cold start, and pass count is the
    whole cost of a refresh. Between strided refreshes A drifts little,
    so carrying the previous refresh's per-pixel iterate ``v`` lets
    ``warm_iters`` (default 12) passes reach the same accuracy (<=2e-3 error
    under 2% A-drift per refresh, exact otherwise) — ~4x cheaper
    refreshes than :class:`~proxmin_tpu.utils.StridedStepper` wrapping
    :func:`step_pgm`. The first refresh runs ``cold_iters`` passes.

    Implements the stepper protocol (``init_state`` / ``__call__``) plus
    the driver hooks ``split_data`` (W rides as a jit argument, not a
    trace constant) and ``stepper_cache_key``.

    ``adapt=True`` grows the refresh interval while the measured bound
    drift stays below ``(1 - safety) / 2`` — the reference
    ``ApproximateCache`` policy (``proxmin/utils.py:
    124-190``) carried in the solver state (:func:`utils.grow_stride`):
    as A settles, the power-iteration refresh amortizes away.
    """

    def init_state(self, X, G):
        A, S = X
        dtype = jnp.result_type(A, S, self.W)
        v0 = _weighted_lipschitz_S_v0(self.W.shape[1], A.shape[1], dtype)
        zero = jnp.zeros((), dtype)
        return ((zero, zero), v0, jnp.int32(self.stride), jnp.int32(0))

    segmentable = True  # pgm may hoist the refresh out of the hot loop

    def segment_refresh(self, state, X, it):
        """Compute fresh steps + warm iterate (shared by the in-body
        ``lax.cond`` path and pgm's segmented mode)."""
        A, S = X
        W = self.W
        dtype = jnp.result_type(A, S, W)
        cached, v, stride, _ = state
        LA = _weighted_lipschitz_A(S, W)
        LS, v_new = _weighted_lipschitz_S(A, W, self._refresh_iters(it),
                                          v0=v, return_v=True)
        steps = (jnp.asarray(self.safety / LA, dtype),
                 jnp.asarray(self.safety / LS, dtype))
        if self.adapt:
            stride = utils.grow_stride(
                stride, cached, steps, (1.0 - self.safety) / 2,
                self.max_stride, first=(it == 0),
            )
        return steps, (steps, v_new, stride, it + stride)

    def state_stride(self, state):
        """Segmented-mode hook: current refresh interval in the carry."""
        return state[2]

    def state_steps(self, state):
        """Segmented-mode hook: the cached steps held in the carry."""
        return state[0]

    def segment_end(self, state, it):
        """Segmented-mode hook: the global iteration of the next refresh
        (the end of the segment starting at ``it``)."""
        return state[3]

    def __call__(self, state, X, it, G):
        state = jax.lax.cond(
            it >= state[3],
            lambda args: self.segment_refresh(args, X, it)[1],
            lambda args: args,
            state,
        )
        return state[0], state

    _cache_tag = "wnmf"


class WeightedBSDMMStepper(_WeightedStepperBase):
    """Stateful per-block step callable for the weighted bsdmm CMF path
    (the bsdmm driver's stateful-steps protocol).

    Replaces ``partial(step_pgm, W=W)[j]`` + the driver-side stride cond:
    each block's refresh computes ONLY that block's bound (the plain
    adapter evaluated BOTH bounds per block — 2x waste), the S-block's
    batched power iterate warm-starts across refreshes (cold
    ``cold_iters`` passes on the first refresh, ``warm_iters`` after,
    dynamic trip count), and the refreshed steps carry in the driver's
    ``steps_f`` slot with a ``safety`` shrink — the bsdmm analogue of
    :class:`WeightedPGMStepper`.
    """

    _cache_tag = "wbsdmm"

    def init_bsdmm_state(self, xs):
        A, S = xs
        dtype = jnp.result_type(A, S)
        v0 = _weighted_lipschitz_S_v0(self.W.shape[1], A.shape[1], dtype)
        # per-block refresh interval + next-refresh sweep (index 0 = A
        # block, 1 = S block) ride with the power iterate; fixed-stride
        # mode carries them too (the next-refresh mechanism reproduces
        # the `it % stride == 0` schedule exactly) so both modes share
        # one state shape and one code path
        return (v0, jnp.full((2,), self.stride, jnp.int32),
                jnp.zeros((2,), jnp.int32))

    @property
    def segmented_bsdmm(self):
        """Opt into the driver's segmented loop when refreshes are
        actually strided: mid-segment sweeps then run with frozen steps
        and WITHOUT the power iterate in the hot carry (a refresh
        ``lax.cond`` threading the (N, K) iterate costs every
        iteration, not every refresh)."""
        return self.stride > 1 or self.adapt

    def state_seg_end(self, state):
        """Segmented-loop hook: the next sweep at which ANY block is
        due a refresh (per-block next-refresh clocks, ``state[2]``)."""
        return jnp.min(state[2])

    def _grow(self, stride_j, cached, step_new, it):
        """Per-block ApproximateCache growth/shrink (identity when not
        adaptive); suppressed on the first sweep (the carried step
        initializes to 1.0, not a real bound, so first-refresh 'drift'
        would be meaningless)."""
        if not self.adapt:
            return stride_j
        return utils.grow_stride(
            stride_j, (cached,), (step_new,),
            (1.0 - self.safety) / 2, self.max_stride, first=(it == 0),
        )

    def __call__(self, Xs, j=None, state=None, it=None, cached=None):
        A, S = Xs
        W = self.W
        v, strides, nxt = state
        refresh_now = it >= nxt[j]

        if j == 0:
            # A-block bound; the power iterate passes through untouched
            # (outside the cond — no 28 MB flow through the branch)
            def refresh_a():
                s_new = jnp.asarray(
                    self.safety / _weighted_lipschitz_A(S, W), cached.dtype)
                stride_j = self._grow(strides[0], cached, s_new, it)
                return s_new, stride_j, it + stride_j

            step, stride_j, nxt_j = jax.lax.cond(
                refresh_now, refresh_a,
                lambda: (cached, strides[0], nxt[0]),
            )
            return step, (v, strides.at[0].set(stride_j),
                          nxt.at[0].set(nxt_j))

        def refresh_s(v):
            LS, v = _weighted_lipschitz_S(A, W, self._refresh_iters(it),
                                          v0=v, return_v=True)
            s_new = jnp.asarray(self.safety / LS, cached.dtype)
            stride_j = self._grow(strides[1], cached, s_new, it)
            return s_new, v, stride_j, it + stride_j

        step, v, stride_j, nxt_j = jax.lax.cond(
            refresh_now, refresh_s,
            lambda v: (cached, v, strides[1], nxt[1]), v,
        )
        return step, (v, strides.at[1].set(stride_j), nxt.at[1].set(nxt_j))



def pgm_nmf_iteration(A, S, Y):
    """One reference-math PGM-NMF iteration: gradients, Lipschitz steps,
    non-negativity prox, and the per-factor fixed-point convergence norms
    as a live output (so benchmarks of this body cannot have the norms
    dead-code-eliminated). Shared by ``bench.py``,
    ``benchmarks/engine_scaling.py`` and ``__graft_entry__``.

    Returns ``(A_new, S_new, converged_at_zero_tol)``.
    """
    gA, gS = grad_likelihood(A, S, Y=Y)
    sA, sS = step_pgm(A, S)
    A_new = operators.prox_plus(A - sA * gA, sA)
    S_new = operators.prox_plus(S - sS * gS, sS)
    conv = jnp.logical_and(
        jnp.sum((A_new - A) ** 2) <= 0.0 * jnp.sum(A_new ** 2),
        jnp.sum((S_new - S) ** 2) <= 0.0 * jnp.sum(S_new ** 2),
    )
    return A_new, S_new, conv


def step_adaprox(*X, it=None):
    """Per-element AdaProx step heuristic (reference ``nmf.py:91-93``)."""
    A, S = X
    return (jnp.mean(A, axis=0) / 10, jnp.mean(S, axis=1, keepdims=True) / 10)



def _cached_runner(builder):
    """Structural memoization for the fused-runner builders.

    ``functools.lru_cache`` would key prox callables by identity, so a
    per-call ``functools.partial(prox_soft, thresh=...)`` (the
    documented way to bind prox options) would miss every time and pay
    a full retrace+recompile per solve. Here callables key via
    :func:`solvers.common.callable_key` (partials key structurally by
    wrapped function + bound values); a key made uncacheable by mutable
    bound NumPy data builds fresh — always correct, never stale."""
    cache = {}

    @functools.wraps(builder)
    def get(*args, **kw):
        from .solvers.common import cacheable, callable_key

        # a runner traced for the kernels' interpreter must not serve a
        # compiled call, nor the other way round
        parts = [nmf_kernels.INTERPRET]
        parts += [callable_key(a) if callable(a) else a for a in args]
        for k in sorted(kw):
            v = kw[k]
            parts.append((k, callable_key(v) if callable(v) else v))
        key = tuple(parts)
        if not cacheable(key):
            return builder(*args, **kw)
        if key not in cache:
            if len(cache) >= 64:
                cache.clear()
            cache[key] = builder(*args, **kw)
        return cache[key]

    get.cache_clear = cache.clear
    return get


def _poison_loss(loss, *norms):
    """Failure detection for the fused/sharded engines: return ``loss``
    with NaN substituted when any of the post-update ``norms`` is
    non-finite. The kernel's loss is computed from the PRE-update
    iterate, so alone it would detect a divergence one iteration late —
    and miss one produced on the final allowed iteration entirely;
    poisoning it from the post-update convergence norms (already
    computed) closes both gaps with zero extra passes."""
    finite = jnp.asarray(True)
    for v in norms:
        finite = jnp.logical_and(finite, jnp.isfinite(v))
    return jnp.where(finite, loss, jnp.nan)


def _fused_fp_conv(d_sq, n_sq, e_rel):
    """Fixed-point test for the fused engines, with the same non-finite
    hardening as :func:`utils.fixed_point_converged`: a diverging
    iterate (inf/nan norms) is never "converged" (``inf <= inf`` would
    otherwise pass for any ``e_rel > 0``)."""
    ok = d_sq <= e_rel ** 2 * n_sq
    finite = jnp.logical_and(jnp.isfinite(d_sq), jnp.isfinite(n_sq))
    return jnp.logical_and(ok, finite)


@_cached_runner
def _make_fused_pgm_runner(prox_A, prox_S, e_rel, tile_n,
                           C, K, N, dtype, store_dtype=None):
    """Build (and cache) the jitted fused-PGM solve for one problem
    configuration. Everything — the casts, the while-loop of fused kernel
    steps — happens inside one compiled executable, so repeated
    solves pay zero retrace/dispatch overhead.

    ``store_dtype=jnp.bfloat16`` stores S/Y at half the memory footprint
    (compute stays f32); the fixed-point residual then floors at bf16
    quantization (~4e-3 relative), so use only with loose tolerances.
    ``tile_n`` is the kernel's pixel tile
    (:func:`ops.nmf_kernels.pixel_tile`)."""
    import jax
    from .ops.nmf_kernels import fused_nmf_pgm_step

    store_dtype = jnp.dtype(store_dtype or jnp.float32)

    @jax.jit
    def run(A, S, Y, max_iter, *, conv_A0=False, conv_S0=False,
            div0=False, loss0=jnp.inf, SSt0=None):
        # the resume kwargs (``state=`` continuation) carry the terminal
        # flags, the last loss (so a no-op continuation of a stopped
        # solve reports the real loss, not the inf init), and the
        # kernel's own S S^T Gram — a fresh Gram has a different
        # contraction order, and the ULP difference in the step sizes
        # compounds over iterations
        A_p = A.astype(jnp.float32)
        S_p = S.astype(store_dtype)
        Y_p = Y.astype(store_dtype)
        div0_t = jnp.asarray(div0, bool)

        def body(carry):
            A, S, SSt, it, _, _, _ = carry
            # exact top eigenvalues of the tiny K×K Grams
            sA = 1.0 / jnp.linalg.eigvalsh(SSt)[-1]
            sS = 1.0 / jnp.linalg.eigvalsh(
                jnp.dot(A.T, A, precision=TINY_PRECISION))[-1]
            gA, S_new, SSt_new, loss, dS_sq, nS_sq = fused_nmf_pgm_step(
                A, S, Y_p, sS, prox_S=prox_S, tile_n=tile_n
            )
            A_new = prox_A(A - sA * gA, sA)
            dA_sq = jnp.sum((A_new - A) ** 2)
            nA_sq = jnp.sum(A_new ** 2)
            conv_A = _fused_fp_conv(dA_sq, nA_sq, e_rel)
            conv_S = _fused_fp_conv(dS_sq, nS_sq, e_rel)
            loss = _poison_loss(loss, dA_sq, nA_sq, dS_sq, nS_sq)
            return (A_new, S_new, SSt_new, it + 1, conv_A, conv_S, loss)

        def cond(carry):
            _, _, _, it, conv_A, conv_S, loss = carry
            done = jnp.logical_and(conv_A, conv_S)
            # failure detection: a non-finite loss after >=1 iteration
            # means a diverged iterate (init loss is inf by design), and
            # a carried diverged flag keeps a stopped solve stopped
            bad = jnp.logical_or(
                jnp.logical_and(it > 0,
                                jnp.logical_not(jnp.isfinite(loss))),
                div0_t)
            return jnp.logical_and(
                it < max_iter,
                jnp.logical_not(jnp.logical_or(done, bad)))

        if SSt0 is None:
            SSt_in = jnp.dot(S_p, S_p.T, precision=STREAM_PRECISION,
                             preferred_element_type=jnp.float32)
        else:
            SSt_in = SSt0.astype(jnp.float32)
        init = (A_p, S_p, SSt_in, jnp.int32(0),
                jnp.asarray(conv_A0, bool), jnp.asarray(conv_S0, bool),
                jnp.asarray(loss0, jnp.float32))
        A_f, S_f, SSt_f, it, conv_A, conv_S, loss = jax.lax.while_loop(
            cond, body, init
        )
        return (A_f.astype(dtype), S_f.astype(dtype),
                it, conv_A, conv_S, loss, SSt_f)

    return run


@_cached_runner
def _make_fused_strided_pgm_runner(prox_A, prox_S, e_rel, tile_n,
                                   C, K, N, dtype, stride, adapt=False,
                                   store_dtype=None):
    """UNWEIGHTED strided/segmented variant of the fused-PGM runner:
    the same frozen-step segmented architecture as
    :func:`_make_fused_weighted_pgm_runner` (refresh once per segment
    OUTSIDE the hot inner loop, 0.9 safety shrink, in-carry
    :func:`utils.grow_stride` adaptivity) — but the refresh is EXACT
    and free of pixel-data traffic: the kernel already accumulates the
    just-produced iterate's ``S S^T`` Gram on every step
    (:func:`ops.nmf_kernels.fused_nmf_pgm_step`), so each segment
    boundary only pays two tiny K×K ``eigvalsh`` calls on operands the
    inner loop carries anyway. Per-iteration this drops the exact
    runner's in-loop eigensolves AND its step/Gram data dependence —
    the inner loop is pure fused-kernel streaming, the structure of
    ``_run_segmented``, the weighted runner and the sharded builder.

    Step semantics match the XLA engine's ``StridedStepper(step_pgm)``
    (reference ``ApproximateCache`` policy, ``utils.py:124-190``):
    bounds refreshed from the CURRENT iterate every ``stride``
    iterations, held frozen in between, shrunk by the 0.9 safety
    factor against inter-refresh Lipschitz growth. ``store_dtype``
    behaves as in the exact runner (bf16 S/Y stores, f32 compute;
    refresh Grams come from the kernel's f32 sums either way).
    """
    import jax
    from .ops.nmf_kernels import fused_nmf_pgm_step

    store_dtype = jnp.dtype(store_dtype or jnp.float32)
    stride = max(int(stride or 1), 1)
    safety = 0.9
    budget = (1.0 - safety) / 2   # ApproximateCache growth threshold
    max_stride = 100

    @jax.jit
    def run(A, S, Y, max_iter, *, it0=0, conv_A0=False, conv_S0=False,
            div0=False, loss0=jnp.inf, steps0=None):
        # ``steps0`` (exact resume) carries (step_A, step_S, SSt,
        # stride, next_refresh): the frozen steps, the kernel's own
        # (K, K) Gram of the current S (a fresh Gram has a different
        # contraction order; the ULP difference in the next refresh's
        # steps would compound), and the segment schedule phased
        # against the ``it0`` global clock.
        A_p = A.astype(jnp.float32)
        S_p = S.astype(store_dtype)
        Y_p = Y.astype(store_dtype)
        it0 = jnp.asarray(it0, jnp.int32)
        div0_t = jnp.asarray(div0, bool)

        def exact_steps(A, SSt):
            sA = 1.0 / jnp.linalg.eigvalsh(SSt)[-1]
            sS = 1.0 / jnp.linalg.eigvalsh(
                jnp.dot(A.T, A, preferred_element_type=jnp.float32,
                        precision=TINY_PRECISION))[-1]
            return (jnp.asarray(sA, jnp.float32),
                    jnp.asarray(sS, jnp.float32))

        def make_body(frozen_steps):
            # frozen step scalars; the (K, K) Gram rides the carry so
            # the segment refresh needs no extra pass over S (it is a
            # kernel output either way — 1 KB of carry, not the big-
            # operand lax.cond the segmented architecture exists to
            # avoid)
            sA, sS = frozen_steps

            def body(st):
                A, S, SSt, it, _, _, _ = st
                gA, S_new, SSt_new, loss, dS_sq, nS_sq = (
                    fused_nmf_pgm_step(
                        A, S, Y_p, sS, prox_S=prox_S, tile_n=tile_n,
                    ))
                A_new = prox_A(A - sA * gA, sA)
                dA_sq = jnp.sum((A_new - A) ** 2)
                nA_sq = jnp.sum(A_new ** 2)
                conv_A = _fused_fp_conv(dA_sq, nA_sq, e_rel)
                conv_S = _fused_fp_conv(dS_sq, nS_sq, e_rel)
                loss = _poison_loss(loss, dA_sq, nA_sq, dS_sq, nS_sq)
                return (A_new, S_new, SSt_new, it + 1,
                        conv_A, conv_S, loss)

            return body

        def cond(st):
            it, conv_A, conv_S, loss = st[3], st[4], st[5], st[6]
            done = jnp.logical_and(conv_A, conv_S)
            bad = jnp.logical_or(
                jnp.logical_and(it > it0,
                                jnp.logical_not(jnp.isfinite(loss))),
                div0_t)
            return jnp.logical_and(
                it < it0 + max_iter,
                jnp.logical_not(jnp.logical_or(done, bad)))

        resume = steps0 is not None
        if resume:
            sA0, sS0, SSt0, stride0, seg0 = steps0
            sA_in = jnp.asarray(sA0, jnp.float32)
            sS_in = jnp.asarray(sS0, jnp.float32)
            SSt_in = SSt0.astype(jnp.float32)
            stride_in = jnp.asarray(stride0, jnp.int32)
            seg_in = jnp.asarray(seg0, jnp.int32)
        else:
            z = jnp.zeros((), jnp.float32)
            SSt_in = jnp.dot(S_p.astype(jnp.float32), S_p.T,
                             preferred_element_type=jnp.float32,
                             precision=STREAM_PRECISION)
            sA_in, sS_in = z, z
            stride_in, seg_in = jnp.int32(stride), it0

        st = (A_p, S_p, SSt_in, it0, jnp.asarray(conv_A0, bool),
              jnp.asarray(conv_S0, bool),
              jnp.asarray(loss0, jnp.float32))

        if resume:
            # statically-gated pre-loop: finish the interrupted segment
            # with the carried frozen steps before any refresh
            st = jax.lax.while_loop(
                lambda s: jnp.logical_and(cond(s), s[3] < seg_in),
                make_body((sA_in, sS_in)), st)

        def outer_cond(carry):
            return cond(carry[0])

        def outer_body(carry):
            s, sA_o, sS_o, stride_c, _ = carry
            sA_, sS_ = exact_steps(s[0], s[2])
            sA_n, sS_n = safety * sA_, safety * sS_
            if adapt:
                stride_c = utils.grow_stride(
                    stride_c, (sA_o, sS_o), (sA_n, sS_n), budget,
                    max_stride, first=(s[3] == 0))
            seg_end = s[3] + (stride_c if adapt else jnp.int32(stride))
            s = jax.lax.while_loop(
                lambda x: jnp.logical_and(cond(x), x[3] < seg_end),
                make_body((sA_n, sS_n)), s)
            return (s, sA_n, sS_n, stride_c, seg_end)

        st, sA_f, sS_f, stride_f, seg_f = jax.lax.while_loop(
            outer_cond, outer_body,
            (st, sA_in, sS_in, stride_in, seg_in))

        A_f, S_f, SSt_f, it, conv_A, conv_S, loss = st
        return (A_f.astype(dtype), S_f.astype(dtype),
                it, conv_A, conv_S, loss,
                sA_f, sS_f, SSt_f, stride_f, seg_f)

    return run


@_cached_runner
def _make_fused_weighted_pgm_runner(prox_A, prox_S, e_rel, tile_n,
                                    C, K, N, dtype, stride, adapt=False,
                                    store_dtype=None):
    """Weighted variant of the fused-PGM runner: the kernel consumes the
    weighted residual ``D = W (A S - Y)`` in the same single pass, while
    the weighted Lipschitz bounds (implicit batched power iteration, the
    only part the kernel cannot fuse) refresh every ``stride`` iterations
    in the carry (0.9 safety factor; ``stride=1`` = every iteration,
    matching the reference's semantics exactly). ``adapt=True`` grows
    the refresh interval in-carry while the bound drift stays below
    half the safety slack (:func:`utils.grow_stride`, the reference
    ``ApproximateCache`` policy).

    ``store_dtype=jnp.bfloat16`` stores S/Y/W at half the memory
    footprint — for the weighted kernel that halves ALL of its streaming
    traffic (S in/out + Y + W reads). Compute stays f32; the strided
    Lipschitz refresh computes its bounds from f32 views (the cast fuses
    into the consuming contractions, paid only once per refresh). The
    fixed-point residual floors at bf16 quantization (~4e-3 relative),
    so pair it with loose tolerances, like the unweighted engine's
    ``store_dtype``."""
    import jax
    from .ops.nmf_kernels import fused_nmf_pgm_step

    store_dtype = jnp.dtype(store_dtype or jnp.float32)
    stride = max(int(stride or 1), 1)
    safety = 0.9
    budget = (1.0 - safety) / 2   # ApproximateCache growth threshold
    max_stride = 100

    @jax.jit
    def run(A, S, Y, W, max_iter, *, it0=0, conv_A0=False,
            conv_S0=False, div0=False, loss0=jnp.inf, steps0=None):
        # ``steps0`` (exact resume) carries the refresh-loop state:
        # (step_A, step_S, v, stride, next_refresh) — the frozen
        # Lipschitz steps, the warm-started (N, K) power iterate, and
        # the segment schedule. ``it0`` continues the global clock the
        # schedule is phased against.
        A_p = A.astype(jnp.float32)
        S_p = S.astype(store_dtype)
        Y_p = Y.astype(store_dtype)
        W_p = W.astype(store_dtype)
        it0 = jnp.asarray(it0, jnp.int32)
        div0_t = jnp.asarray(div0, bool)

        def weighted_steps(A, S, v, it):
            # warm-started power iterate v carried in the loop state:
            # 48 passes on the first refresh, 12 after (A drifts little
            # between refreshes; see WeightedPGMStepper). Dynamic trip
            # count, not a cond over two fori_loops (fusion). Bounds are
            # computed from f32 views of the (possibly bf16) stores —
            # the iterate v and every reduction stay f32.
            S32 = S.astype(jnp.float32)
            W32 = W_p.astype(jnp.float32)
            sA = 1.0 / _weighted_lipschitz_A(S32, W32)
            LS, v = _weighted_lipschitz_S(
                A, W32, jnp.where(it == 0, 48, 12), v0=v, return_v=True)
            return (jnp.asarray(sA, jnp.float32),
                    jnp.asarray(1.0 / LS, jnp.float32), v)

        def make_body(frozen_steps):
            """One fused-kernel iteration with FROZEN step scalars —
            the refresh lives in the segmented outer loop (or, at
            stride=1, in the per-iteration body below), never behind a
            ``lax.cond`` carrying the (N, K) power iterate: a cond
            over big state in a hot loop breaks XLA's memory-space
            assignment and lands its cost on EVERY iteration (the XLA
            driver's ``_run_segmented`` and the sharded builder are
            built the same way)."""
            sA, sS = frozen_steps

            def body(st):
                A, S, it, _, _, _ = st
                gA, S_new, _, loss, dS_sq, nS_sq = fused_nmf_pgm_step(
                    A, S, Y_p, sS, W=W_p, prox_S=prox_S, tile_n=tile_n,
                )
                A_new = prox_A(A - sA * gA, sA)
                dA_sq = jnp.sum((A_new - A) ** 2)
                nA_sq = jnp.sum(A_new ** 2)
                conv_A = _fused_fp_conv(dA_sq, nA_sq, e_rel)
                conv_S = _fused_fp_conv(dS_sq, nS_sq, e_rel)
                loss = _poison_loss(loss, dA_sq, nA_sq, dS_sq, nS_sq)
                return (A_new, S_new, it + 1, conv_A, conv_S, loss)

            return body

        def cond(st):
            it, conv_A, conv_S, loss = st[2], st[3], st[4], st[5]
            done = jnp.logical_and(conv_A, conv_S)
            # failure detection: non-finite loss after >=1 iteration of
            # THIS call, or a carried diverged flag (a stopped solve
            # stays stopped on resume)
            bad = jnp.logical_or(
                jnp.logical_and(it > it0,
                                jnp.logical_not(jnp.isfinite(loss))),
                div0_t)
            return jnp.logical_and(
                it < it0 + max_iter,
                jnp.logical_not(jnp.logical_or(done, bad)))

        resume = steps0 is not None
        if resume:
            sA0, sS0, v0, stride0, seg0 = steps0
            sA_in = jnp.asarray(sA0, jnp.float32)
            sS_in = jnp.asarray(sS0, jnp.float32)
            v0 = jnp.asarray(v0, jnp.float32)
            stride_in = jnp.asarray(stride0, jnp.int32)
            seg_in = jnp.asarray(seg0, jnp.int32)
        else:
            z = jnp.zeros((), jnp.float32)
            v0 = _weighted_lipschitz_S_v0(N, K, jnp.float32)
            sA_in, sS_in = z, z
            stride_in, seg_in = jnp.int32(stride), it0

        st = (A_p, S_p, it0, jnp.asarray(conv_A0, bool),
              jnp.asarray(conv_S0, bool),
              jnp.asarray(loss0, jnp.float32))

        if adapt or stride > 1:
            # segmented strided mode (the _run_segmented / sharded
            # builder architecture): refresh once per segment OUTSIDE
            # the hot inner loop; the power iterate and refresh branch
            # never enter the inner carry
            if resume:
                # statically-gated pre-loop: finish the interrupted
                # segment with the carried frozen steps before any
                # refresh — the continuation walks the exact iterations
                # the uninterrupted solve would have
                st = jax.lax.while_loop(
                    lambda s: jnp.logical_and(cond(s), s[2] < seg_in),
                    make_body((sA_in, sS_in)), st)

            def outer_cond(carry):
                return cond(carry[0])

            def outer_body(carry):
                s, sA_o, sS_o, v, stride_c, _ = carry
                sA_, sS_, v = weighted_steps(s[0], s[1], v, s[2])
                sA_n, sS_n = safety * sA_, safety * sS_
                if adapt:
                    stride_c = utils.grow_stride(
                        stride_c, (sA_o, sS_o), (sA_n, sS_n), budget,
                        max_stride, first=(s[2] == 0))
                seg_end = s[2] + (stride_c if adapt
                                  else jnp.int32(stride))
                s = jax.lax.while_loop(
                    lambda x: jnp.logical_and(cond(x), x[2] < seg_end),
                    make_body((sA_n, sS_n)), s)
                return (s, sA_n, sS_n, v, stride_c, seg_end)

            st, sA_f, sS_f, v_f, stride_f, seg_f = jax.lax.while_loop(
                outer_cond, outer_body,
                (st, sA_in, sS_in, v0, stride_in, seg_in))
        else:
            # stride=1 (reference semantics): refresh every iteration,
            # warm iterate in the carry — no branch anywhere
            def body1(carry):
                s, v = carry
                sA_, sS_, v = weighted_steps(s[0], s[1], v, s[2])
                s = make_body((sA_, sS_))(s)
                return (s, v)

            st, v_f = jax.lax.while_loop(
                lambda c: cond(c[0]), body1, (st, v0))
            sA_f, sS_f = sA_in, sS_in
            stride_f, seg_f = stride_in, st[2]

        A_f, S_f, it, conv_A, conv_S, loss = st
        return (A_f.astype(dtype), S_f.astype(dtype),
                it, conv_A, conv_S, loss,
                sA_f, sS_f, v_f, stride_f, seg_f)

    return run


@utils.with_matmul_precision
def nmf_pgm_fused(
    Y,
    A,
    S,
    W=None,
    prox_A=operators.prox_plus,
    prox_S=operators.prox_plus,
    e_rel=1e-3,
    max_iter=1000,
    tile_n=None,
    store_dtype=None,
    step_stride=None,
    step_adapt=False,
    state=None,
):
    """PGM-NMF with the fully-fused Pallas iteration.

    Mathematically identical to ``nmf(algorithm='pgm')`` for the
    unweighted model: each iteration is ONE pass over the pixel data
    (:func:`proxmin_tpu.ops.fused_nmf_pgm_step`): residual, both factor
    gradients, the proxed S update, the next iteration's ``S S^T`` Gram
    and the fixed-point convergence statistics all come out of a single
    read of S/Y. Needs a CUDA GPU (or the kernels' interpreter).
    The Lipschitz recursion stays **exact** (not lagged): the Gram of the
    just-produced S is exactly what the next step size needs.

    ``prox_S`` must be elementwise or factor-axis-local (the kernel
    applies it per pixel tile); pixel-axis-normalizing proxs need the
    sharded path. Weighted problems pass ``W`` (C×N): the kernel fuses
    the weighted residual into the same single pass; the weighted
    Lipschitz bounds refresh every ``step_stride`` iterations (default
    1 = every iteration, the reference's semantics) via implicit power
    iteration outside the kernel.

    ``step_stride > 1`` (or ``step_adapt=True``) on an UNWEIGHTED
    problem selects the segmented frozen-step runner instead of the
    exact recursion: steps refresh once per segment from the
    kernel-carried Gram (two K×K eigensolves, zero extra pixel
    traffic) with the ``StridedStepper`` policy (0.9 safety shrink;
    ``step_adapt`` grows the interval in-carry). The inner loop
    becomes pure kernel streaming, at the price of the strided policy's
    slightly-lagged steps. Unweighted ``step_stride=1``
    without ``step_adapt`` normalizes to the exact engine (current
    steps beat stride-1-lagged ones at identical cost).

    ``store_dtype=jnp.bfloat16`` halves the S/Y (weighted: also W)
    memory **footprint** (compute stays f32) — for problems near the
    device's memory capacity. The fixed-point residual floors at bf16
    quantization, so keep e_rel >= ~1e-2. On weighted problems the
    weighted Lipschitz refresh reads f32 views (cast per refresh,
    amortized by the stride).

    ``tile_n`` overrides the kernel's pixel tile (a power of two; default
    :func:`proxmin_tpu.ops.nmf_kernels.pixel_tile`).

    ``state=`` is the exact warm restart for preempted solves: pass a
    previous ``nmf_pgm_fused`` call's ``.state`` (same weighting /
    stride / ``store_dtype`` configuration) together with its final
    iterates, and the continuation walks the uninterrupted trajectory
    bit-exactly — the kernel's own S Sᵀ Gram (unweighted exact), the
    frozen steps + carried Gram + refresh schedule (unweighted
    strided) or the frozen Lipschitz steps + warm power iterate +
    refresh schedule (weighted) carry through, and a solve that
    already stopped (converged/diverged) stays stopped. This matters most for the
    weighted ``store_dtype`` capacity solves, which no other engine
    can run. ``max_iter`` counts the additional iterations.

    Returns a ``SolverResult`` with ``.x == (A, S)``, ``.iterations``,
    ``.converged``, ``.loss``, ``.state``.
    """
    from .solvers.common import SolverResult, status_from, writeback

    A_in, S_in = A, S  # keep originals for the NumPy in-place contract
    # None means identity (matching nmf()); the kernel-internal None means
    # its builtin non-negativity, which is what prox_plus maps to
    if prox_A is None:
        prox_A = operators.prox_id
    if prox_S is None:
        prox_S = operators.prox_id
    elif prox_S is operators.prox_plus:
        prox_S = None  # the kernel's builtin non-negativity
    from .solvers.common import promote_dtype

    # a full-width store_dtype IS the default layout: normalize it away
    # so f32 ≡ None everywhere (matching nmf()'s auto-routing rule — a
    # state produced through that normalization must resume with the
    # same kwargs)
    if store_dtype is not None and jnp.dtype(store_dtype).itemsize >= 4:
        store_dtype = None
    # keep=store_dtype: a plane already in the storage dtype must NOT
    # promote — the runner casts in-jit (a no-op), and the eager f32
    # copy would arrive as a jit argument, doubling the capacity
    # footprint this mode exists to shrink
    A = promote_dtype(A)
    S = promote_dtype(S, keep=store_dtype)
    Y = promote_dtype(Y, keep=store_dtype)
    C, K = A.shape
    N = S.shape[1]
    tile_n = pixel_tile(K, N, tile_n)
    weighted = W is not None and not _is_unweighted(W)
    # unweighted stride=1 without adapt IS the exact engine (its
    # per-iteration kernel-Gram steps are current, not lagged — strictly
    # better than stride-1-lagged with a safety shrink), so it
    # normalizes to the plain configuration
    strided_u = ((step_stride is not None and int(step_stride) > 1)
                 or bool(step_adapt))
    stride_cfg = ((0 if step_stride is None else int(step_stride),
                   bool(step_adapt)) if (weighted or strided_u)
                  else (0, False))
    sdt_name = jnp.dtype(store_dtype).name if store_dtype else None
    it0 = 0
    conv0 = np.zeros(2, bool)
    div0 = False
    loss0 = np.inf
    steps0 = None
    if state is not None:
        if not (hasattr(state, "get")
                and state.get("kind") == "nmf_pgm_fused"):
            raise ValueError(
                "state= must be a previous nmf_pgm_fused .state dict "
                "(XLA pgm and sharded states carry solver state the "
                "fused loop has no counterpart for — resume those with "
                "their own engines)"
            )
        if bool(state["weighted"]) != weighted:
            raise ValueError(
                "state= was produced under a different weighting (the "
                "carried step state would be wrong)"
            )
        st_cfg = tuple(state.get("stride_config", stride_cfg))
        if (int(st_cfg[0]), bool(st_cfg[1])) != stride_cfg:
            raise ValueError(
                "state= was produced under a different stride "
                "configuration (step_stride={}, step_adapt={} vs this "
                "call's step_stride={}, step_adapt={}); resume with "
                "the same settings".format(
                    st_cfg[0] or None, bool(st_cfg[1]),
                    step_stride, step_adapt)
            )
        if state.get("store_dtype") != sdt_name:
            raise ValueError(
                "state= was produced under store_dtype={} but this "
                "call uses {} — the stored factors (and the carried "
                "step state computed from them) would not round-trip"
                .format(state.get("store_dtype"), sdt_name)
            )
        if int(state.get("tile_n", tile_n)) != tile_n:
            raise ValueError(
                "state= was produced under tile_n={} but this call "
                "uses {} — the carried step state is tile-accumulated, "
                "so a different tiling would drift the continued "
                "trajectory by compounding ULPs; resume with the same "
                "tile_n".format(state.get("tile_n"), tile_n)
            )
        it0 = int(state["it"])
        conv0 = np.asarray(state.get("converged", conv0), bool)
        div0 = bool(np.asarray(state.get("diverged", False)))
        loss0 = float(state.get("loss", np.inf))
        steps0 = state.get("steps")
    if weighted:
        run = _make_fused_weighted_pgm_runner(
            prox_A, prox_S, float(e_rel), tile_n, C, K, N, A.dtype,
            step_stride, adapt=bool(step_adapt),
            store_dtype=jnp.dtype(store_dtype) if store_dtype else None,
        )
        (A_f, S_f, it, conv_A, conv_S, loss,
         sA_f, sS_f, v_f, stride_f, nxt_f) = run(
            A, S, Y, _promote_W(W, Y), max_iter, it0=it0,
            conv_A0=bool(conv0[0]), conv_S0=bool(conv0[1]), div0=div0,
            loss0=loss0, steps0=steps0,
        )
        extra_state = {"steps": (sA_f, sS_f, v_f, stride_f, nxt_f)}
        iterations = int(it) - it0
    elif strided_u:
        run = _make_fused_strided_pgm_runner(
            prox_A, prox_S, float(e_rel), tile_n, C, K, N, A.dtype,
            step_stride, adapt=bool(step_adapt),
            store_dtype=jnp.dtype(store_dtype) if store_dtype else None,
        )
        (A_f, S_f, it, conv_A, conv_S, loss,
         sA_f, sS_f, SSt_f, stride_f, nxt_f) = run(
            A, S, Y, max_iter, it0=it0,
            conv_A0=bool(conv0[0]), conv_S0=bool(conv0[1]), div0=div0,
            loss0=loss0, steps0=steps0,
        )
        extra_state = {"steps": (sA_f, sS_f, SSt_f, stride_f, nxt_f)}
        iterations = int(it) - it0
    else:
        run = _make_fused_pgm_runner(
            prox_A, prox_S, float(e_rel), tile_n, C, K, N, A.dtype,
            store_dtype=jnp.dtype(store_dtype) if store_dtype else None,
        )
        A_f, S_f, it, conv_A, conv_S, loss, SSt_f = run(
            A, S, Y, max_iter,
            conv_A0=bool(conv0[0]), conv_S0=bool(conv0[1]), div0=div0,
            loss0=loss0, SSt0=None if steps0 is None else steps0,
        )
        extra_state = {"steps": SSt_f}
        iterations = int(it)
    A_out, S_out = A_f, S_f

    converged = (bool(conv_A), bool(conv_S))
    loss = float(loss)
    diverged = div0 or (iterations > 0 and not np.isfinite(loss))
    logger.info("Completed %d iterations", iterations)
    status = status_from(all(converged), diverged, logger)
    writeback((A_in, S_in), (A_out, S_out))
    resume_state = {
        "kind": "nmf_pgm_fused", "weighted": weighted,
        "stride_config": stride_cfg, "store_dtype": sdt_name,
        "tile_n": tile_n,
        "it": it0 + iterations,
        "converged": np.asarray(converged, bool), "diverged": diverged,
        "loss": loss,
        **extra_state,
    }
    return SolverResult(
        converged,
        x=(A_out, S_out), iterations=iterations, converged=converged,
        loss=loss, status=status, state=resume_state,
    )


@_cached_runner
def _make_fused_adaprox_runner(prox_A, prox_S, e_rel, tile_n, C, K, N,
                               dtype, b1, b2, eps, moment_dtype=None,
                               warm=False, weighted=False,
                               store_dtype=None):
    """Build (and cache) the jitted fused proximal-Adam solve for one
    problem configuration (``scheme='adam'``, separable proxs, the
    default ``step_adaprox`` mean/10 heuristic).

    Each iteration is ONE streaming pass over the pixel data
    (:func:`proxmin_tpu.ops.nmf_kernels.fused_nmf_adaprox_step`): the
    S-block gradient, both Adam moment EMAs, the bias-corrected step and
    the closed-form separable prox happen in-register per tile — the
    gradient never materializes in HBM and the moments make exactly one
    HBM round trip per iteration (the XLA driver materializes gS and
    re-reads it for each moment EMA). The next iteration's
    ``step_adaprox`` row means are accumulated in the same pass (the
    ``SSt_new`` trick of the fused PGM kernel, applied to row sums), so
    the step recursion stays exact, not lagged.

    ``moment_dtype=jnp.bfloat16`` stores M/V at half the memory footprint
    with the casts fused into the kernel pass (in registers, unlike the
    XLA ``moment_dtype`` path where they are separate passes) —
    traffic drops from 188 to 132 MB/iter at the flagship shape.
    ``weighted=True`` adds the W stream: the kernel consumes the
    weighted residual ``D = W (A S - Y)`` in the same pass (the
    mean/10 step heuristic has no Lipschitz refresh, so — unlike
    weighted PGM — nothing else changes).

    ``store_dtype=jnp.bfloat16`` additionally stores S/Y (weighted:
    also W) reduced — with bf16 moments that takes the flagship naive
    traffic from 132 to 94 MB/iter; the fixed-point residual floors at
    bf16 quantization like the PGM engines' ``store_dtype``.
    """
    import jax
    from .ops.nmf_kernels import fused_nmf_adaprox_step

    sdt = jnp.dtype(store_dtype or jnp.float32)
    mdt = jnp.dtype(moment_dtype or jnp.float32)
    tiny = float(np.finfo(np.float32).tiny)

    @jax.jit
    def run(A, S, Y, *rest, it0=0, conv_A0=False, conv_S0=False,
            div0=False, loss0=jnp.inf, rowsum0=None):
        # weighted signature: (A, S, Y, W, max_iter, *moments) — W
        # directly after the data, matching export_nmf_solver's
        # weighted artifact ordering; unweighted: (A, S, Y, max_iter,
        # *moments). ``it0`` (traced) continues the global Adam
        # bias-correction clock on exact warm restart (``state=``);
        # the carried terminal flags keep a solve that already stopped
        # (converged/diverged) stopped on resume.
        if weighted:
            W_in, max_iter, *moments = rest
            W_p = W_in.astype(sdt)
        else:
            max_iter, *moments = rest
            W_p = None
        it0 = jnp.asarray(it0, jnp.int32)
        A_p = A.astype(jnp.float32)
        S_p = S.astype(sdt)
        Y_p = Y.astype(sdt)
        if warm:
            # warm start (reference algorithms.py:347-359 semantics: the
            # moments carry over, the bias-correction clock restarts)
            MA_in, VA_in, MS_in, VS_in = moments
            MA0 = MA_in.astype(jnp.float32)
            VA0 = VA_in.astype(jnp.float32)
            MS0 = MS_in.astype(mdt)
            VS0 = VS_in.astype(mdt)
        else:
            MA0 = jnp.zeros((C, K), jnp.float32)
            VA0 = jnp.zeros((C, K), jnp.float32)
            MS0 = jnp.zeros((K, N), mdt)
            VS0 = jnp.zeros((K, N), mdt)

        def body(carry):
            (A, S, MS, VS, MA, VA, rowsum, it, _, _, _) = carry
            t = (it + it0 + 1).astype(jnp.float32)
            b1_t = jnp.asarray(b1, jnp.float32)
            bc1 = 1.0 / (1.0 - b1_t ** t)
            bc2 = 1.0 / (1.0 - jnp.asarray(b2, jnp.float32) ** t)
            scalars = jnp.stack([b1_t, bc1, bc2])

            # step_adaprox (reference nmf.py:91-93): alpha_A =
            # mean(A, 0)/10 per column, alpha_S = mean(S, 1)/10 per row
            # — the S row sums come from the previous kernel pass
            alpha_A = jnp.sum(A, axis=0) / C / 10.0          # (K,)
            alpha_S = rowsum / N / 10.0                      # (K, 1)

            gA, S1, MS1, VS1, rowsum1, loss, dS_sq, nS_sq = (
                fused_nmf_adaprox_step(
                    A, S, MS, VS, Y_p, alpha_S, scalars, W=W_p,
                    prox_S=prox_S, b2=b2, eps=eps, tile_n=tile_n,
                )
            )
            rowsum1 = rowsum1[:, None]

            # A block (tiny, plain XLA): same adam phi/psi + separable
            # closed-form prox as the driver (adaprox.py:261-281)
            MA1 = (1.0 - b1_t) * gA + b1_t * MA
            VA1 = (1.0 - b2) * gA ** 2 + b2 * VA
            PhiA = MA1 * bc1
            PsiA = jnp.sqrt(VA1 * bc2) + eps
            PsiA_safe = jnp.maximum(PsiA, tiny)
            A1 = A - alpha_A[None, :] * PhiA / PsiA_safe
            if prox_A is not None:
                A1 = prox_A(A1, alpha_A[None, :] / PsiA_safe)
            else:
                A1 = jnp.maximum(A1, 0.0)

            dA_sq = jnp.sum((A1 - A) ** 2)
            nA_sq = jnp.sum(A1 ** 2)
            conv_A = _fused_fp_conv(dA_sq, nA_sq, e_rel)
            conv_S = _fused_fp_conv(dS_sq, nS_sq, e_rel)
            loss = _poison_loss(loss, dA_sq, nA_sq, dS_sq, nS_sq)
            return (A1, S1, MS1, VS1, MA1, VA1, rowsum1, it + 1,
                    conv_A, conv_S, loss)

        div0_t = jnp.asarray(div0, bool)

        def cond(carry):
            it, conv_A, conv_S, loss = (carry[7], carry[8], carry[9],
                                        carry[10])
            done = jnp.logical_and(conv_A, conv_S)
            # failure detection: non-finite loss after >=1 iteration,
            # or a carried diverged flag (a diverged-then-resumed
            # solve stays stopped)
            bad = jnp.logical_or(
                jnp.logical_and(it > 0,
                                jnp.logical_not(jnp.isfinite(loss))),
                div0_t)
            return jnp.logical_and(
                it < max_iter,
                jnp.logical_not(jnp.logical_or(done, bad)))

        if rowsum0 is None:
            # cold start / XLA-driver state: compute the step-heuristic
            # row sums fresh (the XLA driver carries none)
            rs0 = jnp.sum(S_p.astype(jnp.float32), axis=1, keepdims=True)
        else:
            # exact resume: the kernel's own tile-accumulated row sums
            # (a fresh jnp.sum has a different reduction order — ULP
            # differences there compound into a visibly different
            # trajectory over tens of iterations)
            rs0 = rowsum0.astype(jnp.float32)
        init = (
            A_p, S_p, MS0, VS0, MA0, VA0, rs0,
            jnp.int32(0), jnp.asarray(conv_A0, bool),
            jnp.asarray(conv_S0, bool),
            jnp.asarray(loss0, jnp.float32),
        )
        out = jax.lax.while_loop(cond, body, init)
        (A_f, S_f, MS_f, VS_f, MA_f, VA_f, rowsum_f, it, conv_A, conv_S,
         loss) = out
        return (A_f.astype(dtype), S_f.astype(dtype),
                it, conv_A, conv_S, loss, MA_f, VA_f, MS_f, VS_f, rowsum_f)

    return run


@utils.with_matmul_precision
def nmf_adaprox_fused(
    Y,
    A,
    S,
    W=None,
    prox_A=operators.prox_plus,
    prox_S=operators.prox_plus,
    e_rel=1e-3,
    max_iter=1000,
    b1=0.9,
    b2=0.999,
    eps=1e-8,
    tile_n=None,
    moment_dtype=None,
    store_dtype=None,
    M=None,
    V=None,
    state=None,
):
    """AdaProx-NMF (``scheme='adam'``) with the fused single-pass Pallas
    iteration kernel — grad + moment EMAs + bias correction + separable
    closed-form prox in one pass over S/M/V/Y per iteration. Needs a CUDA
    GPU (or the kernels' interpreter).

    Mathematically identical to
    ``nmf(algorithm='adaprox', separable_prox='auto')`` with the default
    ``step_adaprox`` heuristic and a constant ``b1``: same Adam
    recursion (reference ``algorithms.py:147-160``), same exact scaled
    prox, same fixed-point convergence test. Restrictions mirror the
    fused-PGM engine: separable (elementwise / factor-axis-local) proxs
    only, no callback/trace, no b1 schedule (constant ``b1`` only).
    Weighted problems pass ``W`` (C×N): the kernel consumes the
    weighted residual in the same single pass (the mean/10 steps need
    no Lipschitz refresh, so weighting costs only the W read).

    ``moment_dtype=jnp.bfloat16`` stores the M/V moment arrays at half
    the memory footprint with in-kernel casts — this REDUCES
    per-iteration memory traffic (188 → 132 MB at the flagship), at bf16
    moment precision (~3 decimal digits on the EMAs; iterates and
    convergence stay f32). ``store_dtype=jnp.bfloat16`` additionally
    stores S/Y (weighted: also W) reduced — with bf16 moments, 132 → 94
    MB/iter — at bf16 iterate quantization (fixed-point residuals floor
    ~4e-3 relative; keep e_rel loose, like the PGM engines' store).

    ``M`` / ``V`` warm-start the Adam moments from a previous solve's
    ``.M`` / ``.V`` (each a per-block ``(M_A, M_S)`` tuple — the same
    shape the XLA adaprox driver accepts/returns); like the reference
    (``algorithms.py:347-359``) the bias-correction clock restarts.

    ``state=`` is the EXACT warm restart (mutually exclusive with
    ``M=``/``V=``): moments AND the global bias-correction clock
    continue, so a preempted solve resumes on the uninterrupted
    trajectory. Accepts this engine's own ``.state`` or an XLA adaprox
    ``.state`` from a default-step ``scheme='adam'`` solve (the adam
    scheme carries no Vhat and the default step heuristic is
    stateless, so the two engines' states are interchangeable); the
    returned ``.state`` likewise round-trips into
    ``nmf(algorithm='adaprox', engine='xla', state=...)``.

    Returns a ``SolverResult`` with ``.x == (A, S)``, ``.iterations``,
    ``.converged``, ``.loss``, the final moments ``.M`` / ``.V``, and
    the exact-resume pytree ``.state``.
    """
    from .solvers.common import SolverResult, status_from, writeback

    A_in, S_in = A, S
    if prox_A is None:
        prox_A = operators.prox_id
    if prox_S is None:
        prox_S = operators.prox_id
    elif prox_S is operators.prox_plus:
        prox_S = None  # the kernel's builtin non-negativity
    from .solvers.common import promote_dtype

    # full-width store/moment dtypes ARE the default layout: normalize
    # so f32 ≡ None (matching nmf()'s auto-routing rule)
    if store_dtype is not None and jnp.dtype(store_dtype).itemsize >= 4:
        store_dtype = None
    # keep=store_dtype: see nmf_pgm_fused — promoting a plane already
    # in the storage dtype materializes the f32 copy as a jit argument
    # and defeats the capacity mode
    A = promote_dtype(A)
    S = promote_dtype(S, keep=store_dtype)
    Y = promote_dtype(Y, keep=store_dtype)
    C, K = A.shape
    N = S.shape[1]
    tile_n = pixel_tile(K, N, tile_n)
    weighted = W is not None and not _is_unweighted(W)
    if weighted:
        W = _promote_W(W, Y)
    if moment_dtype is not None and jnp.dtype(moment_dtype).itemsize >= 4:
        moment_dtype = None
    fused_cfg = {
        "tile_n": tile_n,
        "store_dtype": jnp.dtype(store_dtype).name if store_dtype
        else None,
        "moment_dtype": jnp.dtype(moment_dtype).name if moment_dtype
        else None,
    }
    it0 = 0
    conv0 = np.zeros(2, bool)
    div0 = False
    loss0 = np.inf
    rowsum0 = None
    if state is not None:
        assert M is None and V is None, \
            "state= (exact resume) and M=/V= (moment warm start) are " \
            "mutually exclusive"
        if hasattr(state, "get") and state.get("kind") is not None:
            # an nmf_pgm_fused or sharded state reached the adaprox
            # engine (e.g. nmf(algorithm='adaprox', state=<pgm state>))
            raise ValueError(
                "state= is a {!r} resume state, not an adaprox one — "
                "adaprox states carry M/V moments (fused and XLA "
                "drivers interchangeably); resume this state with the "
                "solver/engine that produced it".format(state["kind"])
            )
        if "fused_config" in state and state["fused_config"] != fused_cfg:
            raise ValueError(
                "state= was produced under the fused configuration {} "
                "but this call uses {} — the carried row sums and "
                "moments are tile/dtype-accumulated, so the continued "
                "trajectory would drift; resume with the same tile_n/"
                "store_dtype/moment_dtype".format(
                    state["fused_config"], fused_cfg)
            )
        # terminal flags (absent on pre-r4-final checkpoints: default
        # "not stopped"): a stopped solve stays stopped on resume
        conv0 = np.asarray(state.get("converged", conv0), bool)
        div0 = bool(np.asarray(state.get("diverged", False)))
        loss0 = float(state.get("loss", np.inf))
        # the kernel's own step-heuristic row-sum carry: present on
        # fused states (bit-exact resume); XLA-driver states have none
        # (their steps recompute from S, so a fresh sum is their exact
        # semantics anyway)
        rowsum0 = state.get("rowsum")
        sst = state.get("stepper_state", ()) \
            if hasattr(state, "get") else ()
        if jax.tree_util.tree_leaves(sst):
            # e.g. a strided-stepper XLA solve: its cached-step state
            # has no fused counterpart (fused steps are exact every
            # iteration), so resuming here would silently change the
            # step trajectory mid-solve
            raise ValueError(
                "state= carries stepper state (a strided/stateful-step "
                "solve); the fused adaprox engine computes exact steps "
                "every iteration — resume with engine='xla'"
            )
        M, V = state["M"], state["V"]
        it0 = int(state["it"])
    warm = M is not None or V is not None
    if warm:
        assert M is not None and V is not None, \
            "warm start needs both M and V (a previous solve's .M/.V)"
        MA, MS = M
        VA, VS = V
        assert np.shape(MA) == (C, K) and np.shape(VA) == (C, K)
        assert np.shape(MS) == (K, N) and np.shape(VS) == (K, N)
    run = _make_fused_adaprox_runner(
        prox_A, prox_S, float(e_rel), tile_n, C, K, N, A.dtype,
        float(b1), float(b2), float(eps),
        moment_dtype=jnp.dtype(moment_dtype) if moment_dtype else None,
        warm=warm, weighted=weighted,
        store_dtype=jnp.dtype(store_dtype) if store_dtype else None,
    )
    extra = ((W,) if weighted else ()) + (max_iter,) + (
        (jnp.asarray(MA), jnp.asarray(VA),
         jnp.asarray(MS), jnp.asarray(VS)) if warm else ())
    (A_f, S_f, it, conv_A, conv_S, loss,
     MA_f, VA_f, MS_f, VS_f, rowsum_f) = run(
        A, S, Y, *extra, it0=it0,
        conv_A0=bool(conv0[0]), conv_S0=bool(conv0[1]), div0=div0,
        loss0=loss0, rowsum0=rowsum0)

    converged = (bool(conv_A), bool(conv_S))
    iterations = int(it)
    loss = float(loss)
    diverged = div0 or (iterations > 0 and not np.isfinite(loss))
    logger.info("Completed %d iterations", iterations)
    status = status_from(all(converged), diverged, logger)
    writeback((A_in, S_in), (A_f, S_f))
    # exact-resume pytree, interchangeable with the XLA adaprox driver's
    # (adam carries no Vhat — it stays zeros there — and the default
    # step heuristic is stateless, so those keys are trivial)
    resume_state = {
        "M": (MA_f, MS_f), "V": (VA_f, VS_f),
        "Vhat": (jnp.zeros_like(MA_f), jnp.zeros_like(MS_f)),
        "stepper_state": (),
        "it": jnp.int32(it0 + iterations),
        # terminal flags (interchangeable with the XLA driver's
        # per-block (A, S) layout): a stopped solve stays stopped
        "converged": np.asarray(converged, bool),
        "diverged": diverged,
        # the kernel's tile-accumulated step-heuristic row sums: resume
        # re-seeds from these for a bit-exact continuation (a fresh
        # jnp.sum's different reduction order drifts the trajectory by
        # ULPs that compound over iterations)
        "rowsum": rowsum_f,
        # the no-op-resume loss report + the fused-config validation
        # key (the XLA driver ignores both; its states carry neither,
        # and resume of those recomputes/approximates as documented)
        "loss": loss,
        "fused_config": fused_cfg,
    }
    return SolverResult(
        converged,
        x=(A_f, S_f), iterations=iterations, converged=converged,
        loss=loss, M=(MA_f, MS_f), V=(VA_f, VS_f),
        status=status, state=resume_state,
    )


@utils.with_matmul_precision
def nmf(
    Y,
    A,
    S,
    W=1,
    prox_A=operators.prox_plus,
    prox_S=operators.prox_plus,
    algorithm=None,
    step=None,
    max_iter=1000,
    e_rel=1e-3,
    callback=None,
    engine="xla",
    step_stride=None,
    step_adapt=False,
    mesh=None,
    model_axis=None,
    **algorithm_args,
):
    """Non-negative / constrained matrix factorization.

    Solves ``minimize 0.5 || sqrt(W) . (Y - A S) ||^2`` under arbitrary
    proximal constraints on A and/or S (reference ``nmf.py:96-203``).

    Args:
        Y: target matrix C×N.
        A: initial amplitude matrix C×K (NumPy inputs updated in place).
        S: initial source matrix K×N (NumPy inputs updated in place).
        W: optional weight matrix C×N (or scalar 1 for unweighted).
        prox_A, prox_S: per-factor constraints.
        algorithm: one of ``algorithms.pgm`` / ``algorithms.adaprox`` /
            ``algorithms.bsdmm`` (or the strings "pgm"/"adaprox"/"bsdmm").
            Default: pgm.
        step: optional custom step callable ``step(*X, it=...)``.
        max_iter, e_rel, callback: forwarded to the solver.
        engine: "xla" (default — XLA-fused solver loop), "pallas" (the
            single-pass fused iteration kernels, CUDA GPUs only:
            :func:`nmf_pgm_fused` for pgm with default steps, or
            :func:`nmf_adaprox_fused` for adaprox — adam scheme +
            separable proxs), or "auto": on a CUDA GPU, pgm and adaprox
            solves go to the fused kernels at the shapes where those
            measured faster than the XLA engine (small factor planes
            over many pixels, :func:`_fused_kernel_wins`) — provided
            both proxs are library operators the kernel is known to
            apply correctly per pixel tile (custom proxs: force with
            ``engine='pallas'``) and, for weighted pgm, a
            strided/adaptive step policy. On any other backend "auto"
            is "xla".
        step_stride: recompute the Lipschitz step sizes only every this
            many iterations, with a 0.9 safety factor (pgm/adaprox: via
            an in-carry :class:`~proxmin_tpu.utils.StridedStepper`;
            bsdmm: via the driver's ``steps_f_stride`` carry). The
            weighted bounds cost ~50 passes over W per evaluation, so
            striding them is an order-of-magnitude win on large weighted
            problems for every CMF path (the reference recomputes every
            iteration, ``nmf.py:69-88``).
        step_adapt: GROW the refresh interval while the measured step
            drift stays below half the safety slack — the reference
            ``ApproximateCache`` policy (``utils.py:124-190``) running
            inside the compiled loop (:func:`utils.grow_stride`),
            starting from ``step_stride`` (default 1 when unset) and
            capped at 100. Supported on pgm and adaprox (any engine;
            the pallas engine additionally requires a weighted problem,
            since unweighted steps are exact K×K eigensolves with
            nothing to amortize), on the weighted default-step bsdmm
            path (per-block intervals), and inside the sharded
            whole-solve (``mesh=``). As the factors settle, step
            refreshes become progressively rarer at no accuracy cost
            beyond the safety factor.
        mesh: optional ``jax.sharding.Mesh`` for one-call scale-out: the
            pixel axis of Y/S/W shards over the mesh's ``'data'`` axis
            (A replicates, or channel-shards over ``model_axis`` on a
            2-D mesh). algorithm='pgm' runs the whole solve inside one
            ``shard_map`` with explicit collectives
            (:func:`proxmin_tpu.parallel.nmf_pgm_sharded`); other
            algorithms shard the inputs and let XLA's auto-SPMD insert
            the collectives.
        model_axis: name of the channel (tensor-parallel) mesh axis for
            2-D meshes; None = replicate A.
        algorithm_args: extra solver kwargs (e.g. ``accelerated=True``;
            for adaprox, ``separable_prox="auto"`` enables the exact
            closed-form scaled prox — 3.2x at the flagship with the
            default non-negativity constraints; ``state=`` for exact
            warm restart, below).

    Returns:
        The solver's :class:`~proxmin_tpu.solvers.common.SolverResult`;
        ``result.x == (A, S)``.

    Preemption / warm restart: ``state=result.state`` forwards to the
    solver's exact-resume path (pgm/adaprox/bsdmm alike), so a killed
    long solve continues from its checkpoint on the same trajectory as
    an uninterrupted run — including the Nesterov momentum clock, the
    Adam moments + global bias-correction clock, and the adaptive-stride
    stepper state (cached weighted-Lipschitz steps, grown refresh
    interval, next-refresh clock, warm power iterate)::

        half = nmf(Y, A, S, W=W, step_adapt=True, max_iter=k)
        save_checkpoint(path, x=list(half.x), solver_state=half.state)
        ...
        ckpt = load_checkpoint(path)
        nmf(Y, ckpt["x"][0], ckpt["x"][1], W=W, step_adapt=True,
            max_iter=n - k, state=ckpt["solver_state"])

    Resume with the same data/weights/step configuration (a structure
    mismatch raises). The reference has no analogue — its ``nmf`` always
    restarts momentum, moments, and step caches from scratch
    (``nmf.py:96-203``). Supported on ``engine="xla"`` and BOTH fused
    engines (a fused-PGM state pins the fused engine in the routing,
    like sharded states pin the mesh path). Every state also carries
    its terminal flags, so a solve that already stopped (converged or
    diverged) resumes as a no-op. Under ``mesh=``, a state produced by
    the explicit-collective sharded pgm solve (``kind ==
    'nmf_pgm_sharded'``) resumes that path exactly — iteration clock,
    frozen step scalars, refresh interval, segment boundary, and the
    sharded power iterate all carry through — while single-device
    solver states resume via the auto-SPMD path.

    Note on repeat-solve caching: the compiled driver is reused across
    calls when the data arguments key identically. NumPy ``Y``/``W`` up
    to 64 MiB are content-hashed (equal data ⇒ cache hit, ~ms repeat
    solves; in-place mutation ⇒ fresh trace, never stale). Above that,
    pass ``Y``/``W`` as jax arrays and reuse the same objects to get
    cache hits without hashing overhead.

    Scale note: Y/W are bound with ``functools.partial`` internally, so
    the drivers pass them to the compiled program as runtime arguments
    (compile time does not grow with the data; 50M-pixel problems are
    routine on one chip). If you write custom ``grad``/``step``/``prox``
    callables over large arrays, bind the data the same way —
    ``functools.partial(fn, Y=Y)`` — rather than capturing it in a
    closure, which would be baked into the compiled program as a
    constant.
    """
    if algorithm is None:
        algorithm = algorithms.pgm
    if isinstance(algorithm, str):
        if algorithm.lower() not in ("pgm", "adaprox", "bsdmm"):
            # restrict to nmf's dispatch set: 'admm'/'sdmm' resolve as
            # attributes but nmf has no routing for them and would die
            # much later with an opaque message
            raise ValueError(
                f"unknown algorithm {algorithm!r}; nmf supports 'pgm', "
                "'adaprox', and 'bsdmm' (reference nmf.py:141)"
            )
        algorithm = getattr(algorithms, algorithm.lower())

    if (np.ndim(Y) != 2 or np.ndim(A) != 2 or np.ndim(S) != 2
            or np.shape(A)[0] != np.shape(Y)[0]
            or np.shape(A)[1] != np.shape(S)[0]
            or np.shape(S)[1] != np.shape(Y)[1]):
        raise ValueError(
            f"factorization shape mismatch: Y {np.shape(Y)}, "
            f"A {np.shape(A)}, S {np.shape(S)} — need Y (C, N), "
            "A (C, K), S (K, N) with Y = A @ S"
        )

    # half/integer inputs promote to the default float dtype on EVERY
    # engine route (XLA drivers promote in tupleize; the fused/sharded
    # paths would otherwise run — or hang — in the input dtype).
    # Same-or-wider float NumPy inputs pass through untouched so the
    # reference's in-place writeback contract keeps their identity.
    # Exception: a plane already in a requested reduced store_dtype
    # stays put — promoting it would materialize the f32 copy the
    # capacity mode exists to avoid (the fused engine casts in-jit).
    _keep = algorithm_args.get("store_dtype")
    if _keep is not None and jnp.dtype(_keep).itemsize >= 4:
        _keep = None
    Y = _promote_if_needed(Y, keep=_keep)
    A = _promote_if_needed(A)
    S = _promote_if_needed(S, keep=_keep)
    if not _is_unweighted(W) and np.ndim(W) == 2:
        W = _promote_if_needed(W, keep=_keep)

    if algorithm_args.get("state", True) is None:
        # explicit state=None means "no resume": treat exactly like an
        # absent kwarg so `state=maybe_state` first-slice patterns don't
        # silently change engine routing (e.g. off the explicit sharded
        # path)
        del algorithm_args["state"]
    _st = algorithm_args.get("state")
    _sharded_state = (hasattr(_st, "get")
                      and _st.get("kind") == "nmf_pgm_sharded")
    _adaprox_sharded_state = (hasattr(_st, "get")
                              and _st.get("kind")
                              == "nmf_adaprox_sharded")
    if (_sharded_state or _adaprox_sharded_state) and mesh is None:
        raise ValueError(
            "state= is a sharded-solve resume state, which resumes "
            "the explicit-collective sharded solve only — pass the "
            "mesh= this solve runs on (single-device continuation is "
            "not what this state encodes)"
        )
    _fused_pgm_state = (hasattr(_st, "get")
                        and _st.get("kind") == "nmf_pgm_fused")
    if _fused_pgm_state:
        if algorithm is not algorithms.pgm:
            raise ValueError(
                "state= is an nmf_pgm_fused resume state but "
                "algorithm={!r} was requested — a PGM state does not "
                "resume a different algorithm's solve".format(
                    getattr(algorithm, "__name__", algorithm))
            )
        if mesh is not None:
            raise ValueError(
                "state= is an nmf_pgm_fused resume state (single-device "
                "fused engine); it does not resume under mesh= — "
                "continue on one device with engine='pallas'"
            )
        # the state pins the engine that produced it (the XLA driver
        # has no counterpart for the fused loop's carried step state)
        # — same rule as sharded states routing the explicit mesh path
        # regardless of the default engine kwarg
        engine = "pallas"

    if mesh is not None:
        # one-call scale-out: pgm routes to the explicit-collective
        # whole-solve shard_map (weighted + step_stride supported); the
        # other algorithms get auto-SPMD (shard the inputs, run the
        # ordinary driver — XLA inserts the collectives)
        from .parallel import nmf_pgm_sharded, shard_nmf_problem

        if engine == "pallas":
            # the fused Pallas kernels are single-device programs with
            # no SPMD partitioning rule — under a mesh they would
            # gather/replicate the pixel-sharded operands per device
            # (defeating the sharding, or OOMing at the scales that
            # need a mesh in the first place)
            raise ValueError(
                "engine='pallas' does not compose with mesh= (the fused "
                "kernels are single-device); use engine='xla' (pgm gets "
                "the explicit-collective whole-solve shard_map, other "
                "algorithms auto-SPMD)"
            )
        if (algorithm is algorithms.pgm and engine in ("xla", "auto")
                and step is None and callback is None
                and (not algorithm_args
                     or (set(algorithm_args) == {"state"}
                         and _sharded_state))):
            return nmf_pgm_sharded(
                Y, A, S, W=None if _is_unweighted(W) else W, mesh=mesh,
                prox_A=prox_A if prox_A is not None else operators.prox_id,
                prox_S=prox_S if prox_S is not None else operators.prox_id,
                e_rel=e_rel, max_iter=max_iter, model_axis=model_axis,
                step_stride=step_stride, step_adapt=step_adapt,
                state=_st,
            )
        _adaprox_alg = getattr(algorithms, "adaprox", None)
        if (algorithm is _adaprox_alg and engine in ("xla", "auto")
                and step is None and callback is None
                and step_stride is None and not step_adapt
                and algorithm_args.get("scheme", "adam") == "adam"
                and algorithm_args.get("separable_prox", "auto")
                is not False
                and set(algorithm_args) <= {
                    "b1", "b2", "eps", "scheme", "separable_prox",
                    "state"}
                and (algorithm_args.get("state") is None
                     or _adaprox_sharded_state)):
            if _adaprox_separable_ok(
                    prox_A, prox_S,
                    algorithm_args.get("separable_prox", "auto")):
                # explicit-collective whole-solve: the
                # scheme='adam' + separable-prox subset mirrors the
                # fused single-chip engine; everything else falls
                # through to audited auto-SPMD below
                from .parallel import nmf_adaprox_sharded

                return nmf_adaprox_sharded(
                    Y, A, S, W=None if _is_unweighted(W) else W,
                    mesh=mesh, prox_A=prox_A, prox_S=prox_S,
                    e_rel=e_rel, max_iter=max_iter,
                    model_axis=model_axis,
                    b1=algorithm_args.get("b1", 0.9),
                    b2=algorithm_args.get("b2", 0.999),
                    eps=algorithm_args.get("eps", 1e-8),
                    state=_st,
                )
        if _adaprox_sharded_state:
            raise ValueError(
                "state= is an nmf_adaprox_sharded resume state but this "
                "call does not route to the explicit sharded adaprox "
                "solve (algorithm='adaprox', scheme='adam', separable "
                "proxs, default steps, no callback required)"
            )
        if _sharded_state:
            # a sharded-solve state only resumes the explicit path — the
            # ordinary drivers would mis-read its keys (or silently
            # ignore the carried segment boundary)
            raise ValueError(
                "state= is an nmf_pgm_sharded resume state but this "
                "call does not route to the explicit sharded solve "
                "(algorithm='pgm' with default steps, no callback, and "
                "no extra algorithm kwargs required)"
            )
        Yd, Ad, Sd, Wd = shard_nmf_problem(
            mesh, Y, A, S, None if _is_unweighted(W) else W,
            model_axis=model_axis,
        )
        res = nmf(Yd, Ad, Sd, W=Wd if Wd is not None else 1,
                  prox_A=prox_A, prox_S=prox_S, algorithm=algorithm,
                  step=step, max_iter=max_iter, e_rel=e_rel,
                  callback=callback, engine="xla",
                  step_stride=step_stride, step_adapt=step_adapt,
                  **algorithm_args)
        from .solvers.common import writeback as _writeback

        _writeback((A, S), res.x)
        return res

    if engine == "auto":
        # store_dtype routing rule: None or a full-width dtype is a
        # no-op (f32 store IS the default layout) — normalize it away
        # so degenerate config values cannot misroute to the measured-
        # slower f32 fused engines or crash the XLA drivers; a REDUCED
        # store_dtype is a capacity request only the fused kernels can
        # honor, and forces them below
        if "store_dtype" in algorithm_args:
            _sdt = algorithm_args["store_dtype"]
            if _sdt is None or jnp.dtype(_sdt).itemsize >= 4:
                algorithm_args = dict(algorithm_args)
                del algorithm_args["store_dtype"]
        adaprox_alg = getattr(algorithms, "adaprox", None)
        fused_adaprox_ok = False
        if (algorithm is adaprox_alg and step is None
                and callback is None and step_stride is None
                and not step_adapt
                and algorithm_args.get("scheme", "adam") == "adam"
                and set(algorithm_args) <= {
                    "b1", "b2", "eps", "tile_n", "moment_dtype",
                    "store_dtype", "M", "V", "state", "scheme",
                    "separable_prox"}):
            fused_adaprox_ok = _adaprox_separable_ok(
                prox_A, prox_S,
                algorithm_args.get("separable_prox", "auto"))
        pallas_only = set(algorithm_args) & {"tile_n", "store_dtype"}
        weighted = not _is_unweighted(W)
        # the weighted fused runner carries a warm-started power iterate,
        # which is the strided/adaptive policy's semantics, not the
        # every-iteration cold refresh of an unstrided XLA solve; a
        # reduced store_dtype is a capacity request only the fused
        # kernels can honor
        strided = ((step_stride is not None and step_stride > 1)
                   or step_adapt)
        pgm_ok = (
            algorithm is algorithms.pgm and step is None
            and callback is None
            and set(algorithm_args) <= {"tile_n", "store_dtype"}
            and _fused_prox_safe(prox_A, "A")
            and _fused_prox_safe(prox_S, "S")
            and (not weighted or strided
                 or "store_dtype" in algorithm_args)
        )
        kernel_ok = pgm_ok or fused_adaprox_ok
        if pallas_only and not kernel_ok:
            raise ValueError(
                f"{sorted(pallas_only)} are pallas-engine options "
                "but the call is not auto-routable to the fused "
                "kernels (pgm needs default steps, no callback, "
                "and library proxs the kernel can apply per pixel "
                "tile — custom-but-tile-local proxs can force the "
                "engine with engine='pallas'; adaprox needs the "
                "adam scheme and separable proxs)"
            )
        on_cuda = cuda_available()
        if pallas_only and not on_cuda:
            raise ValueError(
                f"{sorted(pallas_only)} are pallas-engine options, and "
                "engine='auto' picks the fused kernels only on a CUDA "
                "GPU; drop them, or pass engine='pallas' explicitly"
            )
        C_, N_ = np.shape(Y)
        K_ = np.shape(A)[1]
        # explicit pallas-only kwargs force the kernels; otherwise the
        # measured region decides (_fused_kernel_wins)
        engine = ("pallas" if kernel_ok and on_cuda
                  and (pallas_only or _fused_kernel_wins(C_, K_, N_))
                  else "xla")

    if engine == "pallas":
        if (algorithm is getattr(algorithms, "adaprox", None)
                and step is None and callback is None):
            # fused proximal-Adam engine: adam scheme, separable proxs,
            # default step heuristic; steps are cheap row means, so
            # stride/adapt have nothing to amortize
            if step_stride is not None or step_adapt:
                raise ValueError(
                    "step_stride/step_adapt do not apply to the fused "
                    "adaprox engine (its mean/10 steps are exact and "
                    "cheap every iteration)"
                )
            aargs = dict(algorithm_args)
            scheme = aargs.pop("scheme", "adam")
            if scheme != "adam":
                raise ValueError(
                    "engine='pallas' adaprox supports scheme='adam' "
                    f"only (got {scheme!r}); use engine='xla'"
                )
            sep = aargs.pop("separable_prox", "auto")
            if sep is False:
                # the fused engine always applies the exact closed-form
                # scaled prox; honoring False would need the XLA
                # sub-iteration loop
                raise ValueError(
                    "separable_prox=False requests the prox "
                    "sub-iteration loop, which the fused adaprox "
                    "engine replaces with the closed form; use "
                    "engine='xla' for sub-iteration semantics"
                )
            from .solvers.common import separable_blocks

            prox_pair = (prox_A, prox_S)
            has = tuple(pj is not None for pj in prox_pair)
            sep_blocks = separable_blocks(prox_pair, has, sep)
            if not all(s or not h for s, h in zip(sep_blocks, has)):
                raise ValueError(
                    "the fused adaprox engine needs separable proxs "
                    "(the in-kernel scaled prox is the closed form); "
                    "use engine='xla' for sub-iteration proxs"
                )
            fused_kw = {k: aargs.pop(k) for k in
                        ("b1", "b2", "eps", "tile_n", "moment_dtype",
                         "store_dtype", "M", "V", "state")
                        if k in aargs}
            if aargs:
                raise ValueError(
                    f"unsupported fused-adaprox options: {sorted(aargs)}"
                )
            return nmf_adaprox_fused(
                Y, A, S, W=None if _is_unweighted(W) else W,
                prox_A=prox_A, prox_S=prox_S, e_rel=e_rel,
                max_iter=max_iter, **fused_kw,
            )
        if (algorithm is not algorithms.pgm or step is not None
                or callback is not None):
            raise ValueError(
                "engine='pallas' supports algorithm='pgm' or "
                "algorithm='adaprox' with default steps and no "
                "callback; use engine='xla'"
            )
        if "state" in algorithm_args:
            _fst = algorithm_args["state"]
            if not (hasattr(_fst, "get")
                    and _fst.get("kind") == "nmf_pgm_fused"):
                # an XLA momentum/stepper state or a sharded state has
                # no counterpart in the fused loop
                raise ValueError(
                    "state= is not an nmf_pgm_fused resume state — the "
                    "fused PGM engine resumes only its own states "
                    "(kernel Gram / frozen weighted steps); resume "
                    "accelerated/strided XLA solves with engine='xla' "
                    "and sharded solves with mesh="
                )
        W_k = None
        if not _is_unweighted(W):
            W_k = _promote_W(W, Y)
        fused_pgm_kw = {k: v for k, v in algorithm_args.items()
                        if k in ("tile_n", "store_dtype", "state")}
        if set(algorithm_args) - set(fused_pgm_kw):
            raise ValueError(
                "unsupported fused-PGM options: "
                f"{sorted(set(algorithm_args) - set(fused_pgm_kw))}"
            )
        return nmf_pgm_fused(
            Y, A, S, W=W_k, prox_A=prox_A, prox_S=prox_S,
            e_rel=e_rel, max_iter=max_iter, step_stride=step_stride,
            step_adapt=step_adapt,
            **fused_pgm_kw,
        )
    elif engine != "xla":
        raise ValueError(f"unknown engine {engine!r}")

    Y_orig, W_orig = Y, W  # pre-conversion identities for adapter caching
    # content-keyed conversion: repeat solves with equal NumPy data reuse
    # the same device array, so the driver-cache keys below repeat too
    # (pass jax arrays directly for zero-overhead hits on >64 MiB data)
    Y = asarray_cached(Y)
    if _is_unweighted(W):
        W = 1
    elif np.isscalar(W) or np.shape(W) != np.shape(Y):
        # scalar or broadcastable weight: materialize the full (C, N)
        # form so the weighted Lipschitz math (which needs W's 2-D
        # structure) works; the reference crashes here
        W = _promote_W(W, Y)
    else:
        W = asarray_cached(W)

    grad = partial(grad_likelihood, Y=Y, W=W)
    X = [A, S]
    prox = [prox_A, prox_S]

    # step_stride routing: pgm/adaprox wrap the stepper in StridedStepper;
    # bsdmm strides the per-block steps_f_cb inside its own carry

    # adaptive striding starts at step_stride (default 1, the reference
    # ApproximateCache's cold start) and grows in-carry
    strided = (step_stride is not None and step_stride > 1) or step_adapt
    stride0 = int(step_stride) if step_stride is not None else 1

    if algorithm is algorithms.pgm:
        if strided:
            if step is None and not _is_unweighted(W):
                # warm-started weighted refresh: ~4x cheaper than the
                # generic StridedStepper wrapping step_pgm (the power
                # iterate carries over between refreshes)
                step = WeightedPGMStepper(W, stride=stride0,
                                          adapt=step_adapt)
            else:
                if step is None:
                    step = partial(step_pgm, W=W)
                from .utils import StridedStepper

                step = StridedStepper(step, 2, stride=stride0,
                                      adapt=step_adapt)
        elif step is None:
            step = partial(step_pgm, W=W)
        return algorithm(
            X, grad, step, prox=prox,
            max_iter=max_iter, e_rel=e_rel, callback=callback,
            **algorithm_args,
        )

    adaprox = getattr(algorithms, "adaprox", None)
    if adaprox is not None and algorithm is adaprox:
        if step is None:
            step = step_adaprox
        if strided:
            from .utils import StridedStepper

            step = StridedStepper(step, 2, stride=stride0,
                                  adapt=step_adapt)
        return algorithm(
            X, grad, step, prox=prox,
            max_iter=max_iter, e_rel=e_rel, callback=callback,
            **algorithm_args,
        )

    bsdmm = getattr(algorithms, "bsdmm", None)
    if bsdmm is not None and algorithm is bsdmm:
        weighted_default = step is None and not _is_unweighted(W)
        if step_adapt and not weighted_default:
            raise ValueError(
                "step_adapt for algorithm='bsdmm' is supported on the "
                "weighted default-step path (the expensive per-block "
                "Lipschitz bounds); use a fixed step_stride for custom "
                "steps or unweighted problems"
            )
        prox_f, step_f = _bsdmm_adapters(Y, W, tuple(prox), step,
                                         Y_orig, W_orig)
        if strided:
            if weighted_default:
                # warm-started per-block weighted bounds (each block's
                # refresh computes only its own bound) — the bsdmm
                # analogue of WeightedPGMStepper
                step_f = WeightedBSDMMStepper(W, stride=stride0,
                                              adapt=step_adapt)
            else:
                algorithm_args = dict(algorithm_args,
                                      steps_f_stride=stride0)
        return bsdmm(
            X, prox_f, step_f,
            max_iter=max_iter, e_rel=e_rel, callback=callback,
            **algorithm_args,
        )

    raise ValueError(f"unsupported algorithm: {algorithm!r}")


def _bsdmm_prox_f(Xj, step_j, Xs=None, j=None, *, Y, W, prox):
    """Block prox_f for the bsdmm CMF path: gradient step then the
    block's constraint prox (reference nmf.py:181-193). Module-level +
    partial-bound so the driver can split Y/W out as jit arguments."""
    grads = grad_likelihood(*Xs, Y=Y, W=W)
    return prox[j](Xj - step_j * grads[j], step_j)


def _bsdmm_step_default(Xs, j=None, *, W):
    return step_pgm(*Xs, W=W)[j]


def _bsdmm_step_custom(Xs, j=None, *, step):
    return step(*Xs)[j]


def _bsdmm_adapters(Y, W, prox, step, Y_orig=None, W_orig=None):
    """Build the bsdmm prox_f/step_f callables: gradient steps wrapped
    as block prox_f (reference nmf.py:181-193; the reference bug of
    referencing an undefined `step_f` when a custom `step` is supplied —
    nmf.py:195-197 — is fixed here).

    Partial-bound (NOT closure-captured) for two reasons: the bsdmm
    driver's split_partial_data passes Y/W to the compiled program as
    jit arguments (compile time must not scale with the data size), and
    ``callable_key`` keys partials STRUCTURALLY — so repeat solves with
    the same device data (including NumPy data stabilized by
    ``asarray_cached``) hit the bsdmm driver cache even though these
    partials are rebuilt every call. No adapter-level memo is needed."""
    prox = tuple(p if p is not None else operators.prox_id for p in prox)

    prox_f = partial(_bsdmm_prox_f, Y=Y, W=W, prox=prox)
    if step is None:
        step_f = partial(_bsdmm_step_default, W=W)
    else:
        step_f = partial(_bsdmm_step_custom, step=step)
    return prox_f, step_f
