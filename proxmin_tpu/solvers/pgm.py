"""Proximal Gradient Method (ISTA / FISTA) — jit-compiled while-loop driver.

accelerator-native re-design of the reference ``pgm`` (``proxmin/
algorithms.py:12-144``): forward-backward splitting with multi-block
coordinate descent (Xu & Yin 2015), optional Nesterov acceleration
(Beck & Teboulle 2009 FISTA) and Beck–Teboulle backtracking line search,
per-block fixed-point convergence test.

Reference semantics preserved: extrapolation/copy ordering, the
``T[jmax] /= 2`` steepest-block backtracking update, the
``||X - X_||^2 <= e_rel^2 ||X||^2`` stopping rule, the ``grads=`` duck-typed
step signature, and the ``(converged, G, S)`` return. The loop itself is a
single ``lax.while_loop`` under ``jax.jit`` with the Nesterov ``t``,
backtracking scales ``T`` and convergence flags all living in the carry —
no host round trips (unless a ``callback`` is given, which switches to a
compiled-step host loop supporting ``StopIteration``).
"""

import logging
from typing import Any, NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from .. import utils
from ..utils import (make_stepper, nesterov_next, fixed_point_norms,
                     fixed_point_verdict, with_matmul_precision)
from .common import (
    DriverCache,
    SolverResult,
    abstract_key,
    cacheable,
    callable_key,
    nested_key,
    normalize_per_block,
    value_key,
    normalize_prox,
    split_partial_data,
    split_stepper_data,
    tupleize,
    writeback,
    zeros_like_shapes,
)

logger = logging.getLogger("proxmin")

__all__ = ["pgm"]

# safety cap on backtracking halvings per outer iteration (2^-60 underflows
# any reasonable step); the reference's inner `while` is uncapped
_MAX_BACKTRACK = 60


class PGMState(NamedTuple):
    x: tuple
    x_prev: tuple          # previous iterate — carried ONLY when
                           # accelerated (Nesterov needs it); () otherwise.
                           # Every full-size carry entry that changes per
                           # iteration costs a buffer write in the compiled
                           # while_loop (XLA assigns fixed carry slots, so
                           # "rotating" buffers means copying); dropping
                           # the gradient and the unused-here x_prev from
                           # the carry cut the flagship driver iteration
                           # from 0.39 to ~0.1 ms.
    t: Any                 # Nesterov momentum scalar
    T: Any                 # (N,) backtracking step scales
    f_prev: Any            # last smooth-function value (backtracking only)
    S: tuple               # last step sizes (small: scalar/per-block)
    stepper_state: Any
    it: Any
    converged: Any         # (N,) bool
    history: Any           # (max_iter, N) per-block relative residuals
                           # (device-side trace buffer; empty when trace off)
    diverged: Any          # bool — a non-finite iterate was produced
    it0: Any               # global iteration offset (warm restart): the
                           # stepper and it-dependent user step functions
                           # see it + it0, so e.g. Barzilai–Borwein's
                           # it==0 init branch and it<=3 stabilization
                           # window don't re-fire on resume; history
                           # indexing and max_iter use the local it


def _make_pgm_body(grad, stepper, prox, e_rel, accelerated, backtracking, f,
                   trace=False, restart=False):
    """Build the single-iteration body (pure state -> state).

    ``restart=True`` (with ``accelerated``) adds O'Donoghue & Candès
    (2015) gradient-based adaptive restart: when the momentum direction
    opposes the progress direction — the oscillation condition
    ``<x_ex - x_new, x_new - x_old> > 0`` — the Nesterov clock resets to
    ``t = 1`` (omega(1) == 0, so the next extrapolation is momentum-free
    regardless of ``x_prev``). One extra fused reduction per iteration;
    kills FISTA's characteristic oscillation on well-conditioned
    directions (FASTA field guide, arXiv:1411.3406 §4)."""
    n = len(prox)

    def body(state: PGMState) -> PGMState:
        it = state.it
        it_g = it + state.it0  # global clock (differs after warm restart)

        # Nesterov extrapolation (omega == 0 at it == 0 since t starts at 1)
        if accelerated:
            omega, t_next = nesterov_next(state.t)
            x_ex = tuple(
                state.x[j] + omega * (state.x[j] - state.x_prev[j])
                for j in range(n)
            )
        else:
            t_next = state.t
            x_ex = state.x

        x_old = state.x  # the reference's X_ copy (algorithms.py:102)

        G = utils._as_tuple(grad(*x_ex))
        S, stepper_state = stepper(state.stepper_state, x_ex, it_g, G)
        S = tuple(jnp.asarray(s) for s in S)

        def prox_step(j, Tj):
            return prox[j](x_ex[j] - Tj * S[j] * G[j], Tj * S[j])

        x_new = tuple(prox_step(j, state.T[j]) for j in range(n))
        T = state.T

        if backtracking:
            # Beck & Teboulle eq. 3.2 (g dropped from F and Q: it cancels)
            f_prev = jax.lax.cond(
                it_g == 0, lambda: jnp.asarray(f(*x_old)),
                lambda: state.f_prev
            )

            def bt_cond(carry):
                x, T_bt, f_now, k = carry
                Q = f_prev + sum(
                    jnp.sum((x[j] - x_old[j]) * G[j])
                    + jnp.sum(0.5 / (T_bt[j] * S[j]) * (x[j] - x_old[j]) ** 2)
                    for j in range(n)
                )
                return jnp.logical_and(f_now > Q, k < _MAX_BACKTRACK)

            def bt_body(carry):
                x, T_bt, f_now, k = carry
                # steepest relative update direction (algorithms.py:121)
                rel = jnp.stack([
                    jnp.max(jnp.abs(S[j] * G[j])) / jnp.max(jnp.abs(x_old[j]))
                    for j in range(n)
                ])
                jmax = jnp.argmax(rel)
                T_bt = T_bt.at[jmax].set(T_bt[jmax] / 2)
                x = tuple(
                    jnp.where(jmax == j, prox_step(j, T_bt[j]), x[j])
                    for j in range(n)
                )
                return x, T_bt, jnp.asarray(f(*x)), k + 1

            f_now = jnp.asarray(f(*x_new))
            x_new, T, f_now, _ = jax.lax.while_loop(
                bt_cond, bt_body, (x_new, T, f_now, jnp.int32(0))
            )
            f_prev_new = f_now
        else:
            f_prev_new = state.f_prev

        # one pair of reductions per block serves the convergence test,
        # the divergence detector AND the trace residual (failure
        # detection per SURVEY.md §5: a non-finite iterate — diverged
        # step, bad prox, NaN data — stops the loop via non-finite norms
        # instead of a separate isfinite pass over the iterate)
        norms = [fixed_point_norms(x_new[j], x_old[j]) for j in range(n)]
        verdicts = [fixed_point_verdict(d, nx, e_rel[j])
                    for j, (d, nx) in enumerate(norms)]
        converged = jnp.stack([c for c, _ in verdicts])
        finite = jnp.stack([fin for _, fin in verdicts]).all()

        if accelerated and restart:
            # adaptive restart (see builder docstring): reset the
            # momentum clock when extrapolation overshoots
            osc = sum(
                jnp.sum((x_ex[j] - x_new[j]) * (x_new[j] - x_old[j]))
                for j in range(n)
            )
            t_next = jnp.where(osc > 0, jnp.ones_like(t_next), t_next)

        history = state.history
        if trace:
            # device-side trace buffer (SURVEY.md §5): per-block relative
            # fixed-point residual sqrt(||x-x_||^2 / ||x||^2), recorded in
            # the preallocated carry array — no host round trip
            res = jnp.stack([
                jnp.sqrt(d / jnp.maximum(nx, 1e-30)) for d, nx in norms
            ])
            history = history.at[it].set(res.astype(history.dtype))

        return PGMState(
            x=x_new,
            x_prev=x_old if accelerated else (),
            t=t_next,
            T=T,
            f_prev=f_prev_new,
            S=S,
            stepper_state=stepper_state,
            it=it + 1,
            converged=converged,
            history=history,
            diverged=jnp.logical_or(state.diverged, jnp.logical_not(finite)),
            it0=state.it0,
        )

    return body


def _init_state(x0, grad, stepper, n, max_iter, trace, accelerated,
                resume=None):
    dtype = jnp.result_type(*[x.dtype for x in x0], jnp.float32)
    G0 = zeros_like_shapes(lambda *x: utils._as_tuple(grad(*x)), *x0)
    stepper_state0 = stepper.init_state(x0, G0)
    S0 = zeros_like_shapes(
        lambda st, x, g: tuple(
            jnp.asarray(s) for s in stepper(st, x, jnp.int32(0), g)[0]
        ),
        stepper_state0, x0, G0,
    )
    if resume is not None:
        # warm restart (checkpoint/resume, mirroring the ADMM family's
        # `state=`): the Nesterov momentum clock + previous iterate, the
        # backtracking scales, and the stepper state continue; the
        # iteration counter restarts (a resumed solve runs up to
        # max_iter further iterations). The reference has no analogue —
        # it restarts FISTA momentum from scratch (algorithms.py:80-87).
        xp = tuple(resume.get("x_prev", ()))
        if accelerated != bool(len(xp)):
            # an accelerated state carries the previous iterate; a plain
            # one carries () — continuing across that mismatch would
            # silently restart (or drop) the Nesterov momentum instead
            # of resuming anything
            raise ValueError(
                "state= was produced under accelerated="
                f"{bool(len(xp))} but this solve has accelerated="
                f"{accelerated}; resume with the same setting"
            )
        x_prev = (tuple(jnp.array(x, copy=True) for x in xp)
                  if accelerated else ())
        t0 = jnp.asarray(resume["t"], dtype)
        T0 = jnp.asarray(resume["T"], dtype)
        f_prev0 = jnp.asarray(resume["f_prev"], dtype)
        it0 = jnp.asarray(resume.get("it", 0), jnp.int32)
        sst0 = resume.get("stepper_state", stepper_state0)
        if jax.tree_util.tree_structure(sst0) != \
                jax.tree_util.tree_structure(stepper_state0):
            raise ValueError(
                "state= was produced under a different step "
                "configuration (stepper state structure mismatch); "
                "resume with the same step arguments"
            )
        # carried terminal flags (default: not stopped, for pre-r4-final
        # checkpoints that lack them): a stopped solve stays stopped
        conv0 = jnp.asarray(resume.get("converged", np.zeros(n, bool)),
                            bool).reshape((n,))
        div0 = jnp.asarray(resume.get("diverged", False), bool)
    else:
        x_prev = (tuple(jnp.array(x, copy=True) for x in x0)
                  if accelerated else ())
        t0 = jnp.asarray(1.0, dtype)
        T0 = jnp.ones((n,), dtype)
        f_prev0 = jnp.asarray(jnp.inf, dtype)
        sst0 = stepper_state0
        it0 = jnp.int32(0)
        conv0 = jnp.zeros((n,), bool)
        div0 = jnp.asarray(False)
    # fresh buffers: the initial state must not alias user-provided arrays
    # (device conversion below is a copy for NumPy inputs and an explicit
    # copy for jax inputs)
    return PGMState(
        x=tuple(jnp.array(x, copy=True) for x in x0),
        x_prev=x_prev,
        t=t0,
        T=T0,
        f_prev=f_prev0,
        S=tuple(S0),
        stepper_state=sst0,
        it=jnp.int32(0),
        converged=conv0,
        history=jnp.zeros((max_iter if trace else 0, n), dtype),
        it0=it0,
        diverged=div0,
    )


_PGM_CACHE = DriverCache()


def _const_step_key(v):
    """Key one constant step value: scalars (incl. 0-d arrays) by value,
    immutable jax arrays by identity, mutable NumPy arrays UNCACHEABLE
    (id-keying them would serve stale traces after in-place mutation —
    same policy as :func:`common.value_key`)."""
    try:
        return ("v", float(v))
    except (TypeError, ValueError):
        return value_key(v)


def _stepper_cache_key(step, stepper):
    from ..utils import (
        BarzilaiBorweinStepper, ConstantStepper, StridedStepper,
    )

    if hasattr(stepper, "stepper_cache_key"):
        # custom stepper classes (e.g. nmf.WeightedPGMStepper) key
        # themselves — including UNCACHEABLE for mutable NumPy data
        return stepper.stepper_cache_key()
    if isinstance(stepper, StridedStepper):
        # _orig may be a callable OR a raw step value; value keying via
        # nested_key keeps mutable NumPy arrays UNCACHEABLE here too
        orig = stepper._orig
        okey = callable_key(orig) if callable(orig) else nested_key(orig)
        if not cacheable(okey):
            return okey
        return ("strided", stepper.stride, stepper.safety, stepper.adapt,
                stepper.max_stride, okey)
    if isinstance(stepper, ConstantStepper):
        return ("const", tuple(_const_step_key(v) for v in stepper.value))
    if isinstance(stepper, BarzilaiBorweinStepper):
        return ("bb", stepper.type, stepper.r)
    return ("fn", callable_key(step))


def _keep_going(state, max_iter):
    """The shared loop-continue predicate: under the iteration cap, not
    all blocks converged, no divergence detected."""
    go = jnp.logical_and(
        state.it < max_iter, jnp.logical_not(jnp.all(state.converged))
    )
    return jnp.logical_and(go, jnp.logical_not(state.diverged))


def _run_fused(x0, body, max_iter, n):
    return jax.lax.while_loop(
        lambda s: _keep_going(s, max_iter), body, x0
    )


class _FrozenStepper:
    """Stepper returning fixed (traced) steps — used by the segmented
    runner so the standard body needs no stepper/cond in the hot loop."""

    def __init__(self, steps):
        self.steps = steps

    def __call__(self, state, X, it, G):
        return self.steps, state


def _run_segmented(state, grad, stepper, prox, e_rel, accelerated,
                   backtracking, f, trace, max_iter, n, resuming=False,
                   restart=False):
    """Strided-stepper execution as nested loops: the outer loop refreshes
    the steps once per ``stride`` via ``stepper.segment_refresh``, the
    inner while-loop runs the iterations with frozen steps.

    Iterate-identical to running the stepper's per-iteration ``lax.cond``
    inside the body (refreshes happen at the same ``it`` from the same
    extrapolated iterate), but the cond and the stepper state (e.g. the
    28 MB warm-start power iterate of ``nmf.WeightedPGMStepper``) stay
    OUT of the hot inner carry: a per-iteration cond breaks
    gradient/prox fusion and copies the stepper state every
    iteration.

    Adaptive steppers (``stepper.adapt``) carry a DYNAMIC refresh
    interval in their state (the reference ``ApproximateCache`` growth
    policy, ``utils.grow_stride``); segment boundaries come from the
    stepper's ``segment_end`` hook on the global iteration clock.

    ``resuming=True`` (a ``state=`` warm restart, static at trace time)
    first finishes the interrupted segment: the carried cached steps
    serve until the carried next-refresh clock, then the normal refresh
    loop takes over — so the continuation walks the same iterations as
    the uninterrupted solve. Fresh solves compile WITHOUT the pre-loop
    and with the refresh unconditional: wrapping the refresh in a
    ``lax.cond`` instead (the obvious alternative) threads the big
    stepper state through a conditional and re-creates the
    staged copies described below — the whole point of segmented
    mode."""

    def go(st):
        return _keep_going(st, max_iter)

    def seg_inner(st, steps, sst, seg_end):
        """Run iterations [st.it, seg_end) with frozen ``steps``.

        The stepper state (e.g. WeightedPGMStepper's 28 MB warm-start
        iterate) is loop-invariant inside the segment — keep it OUT of
        the inner carry, so the loop does not copy it every
        iteration."""
        body = _make_pgm_body(grad, _FrozenStepper(steps), prox, e_rel,
                              accelerated, backtracking, f, trace=trace,
                              restart=restart)

        def strip(s2):
            return s2._replace(stepper_state=())

        def body_stripped(s2):
            return strip(body(s2._replace(stepper_state=sst)))

        def inner_cond(s2):
            return jnp.logical_and(go(s2), s2.it < seg_end)

        st = jax.lax.while_loop(inner_cond, body_stripped, strip(st))
        return st._replace(stepper_state=sst)

    def outer_body(st):
        # the extrapolated iterate exactly as the body would compute it
        # at this iteration (omega recomputed, t not advanced)
        if accelerated:
            omega, _ = nesterov_next(st.t)
            x_ex = tuple(
                st.x[j] + omega * (st.x[j] - st.x_prev[j]) for j in range(n)
            )
        else:
            x_ex = st.x
        it_g = st.it + st.it0
        steps, sst = stepper.segment_refresh(st.stepper_state, x_ex, it_g)
        steps = tuple(jnp.asarray(s) for s in steps)
        st = st._replace(S=steps, stepper_state=sst)
        # segment end on the GLOBAL clock (the stepper's next-refresh
        # iteration), mapped back to the local counter
        seg_end = stepper.segment_end(sst, it_g) - st.it0
        return seg_inner(st, steps, sst, seg_end)

    if resuming:
        # finish the interrupted segment with the carried cached steps
        # (zero iterations when the kill landed exactly on a refresh
        # boundary); the outer refresh then fires exactly on schedule
        sst0 = state.stepper_state
        steps0 = tuple(jnp.asarray(s)
                       for s in stepper.state_steps(sst0))
        seg_end0 = (stepper.segment_end(sst0, state.it + state.it0)
                    - state.it0)
        state = seg_inner(state._replace(S=steps0), steps0, sst0,
                          seg_end0)

    return jax.lax.while_loop(go, outer_body, state)


@with_matmul_precision
def pgm(
    X,
    grad,
    step,
    prox=None,
    accelerated=False,
    restart=False,
    backtracking=False,
    f=None,
    e_rel=1e-6,
    max_iter=1000,
    callback=None,
    trace=False,
    state=None,
):
    """Proximal Gradient Method (ISTA; FISTA when ``accelerated=True``).

    Drop-in equivalent of the reference ``proxmin.pgm``
    (``algorithms.py:12-144``). All user callables (``grad``, ``step``,
    ``prox``, ``f``) must be jit-traceable (jnp operations, no Python side
    effects); ``step`` may be a float / per-block tuple, a callable
    ``step(*X, it=..., [grads=...])``, or a stepper object such as
    :class:`proxmin_tpu.utils.BarzilaiBorweinStepper`.

    Args:
        X: initial iterate — array or list of arrays (blocks). NumPy inputs
            are updated in place like the reference; the solution is also
            available as ``result.x``.
        grad: gradient of the smooth part, ``grad(*X) -> dX`` (tuple for
            multi-block). ``None`` differentiates ``f`` via ``jax.grad``
            (requires ``f``; the accelerator-native successor of the reference's
            autograd compatibility, reference ``README.md:33``).
        step: step size(s); should be < 2/L with L the Lipschitz constant.
        prox: proximal operator(s) ``prox(X, step) -> X``; None = identity.
        accelerated: Nesterov/FISTA acceleration.
        restart: with ``accelerated``, O'Donoghue & Candès adaptive
            restart — the momentum clock resets whenever extrapolation
            overshoots (the gradient-based oscillation test), which
            restores monotone-like descent and is often several times
            faster in iterations on well-conditioned problems (FASTA
            field guide, arXiv:1411.3406 §4). Off by default: the
            reference has no restart, and parity tests pin plain FISTA.
        backtracking: Beck–Teboulle backtracking line search (needs ``f``).
        f: the smooth function itself — required for ``backtracking``
            and for the ``grad=None`` autodiff mode.
        e_rel: relative fixed-point tolerance (scalar or per block).
        max_iter: iteration cap.
        callback: optional ``callback(*X, it=...)`` host hook; switches to
            the compiled-step host loop. Raising ``StopIteration`` from the
            callback terminates cleanly (reference ``algorithms.py:137``).
        trace: record per-iteration relative residuals per block in a
            device-side buffer, returned as ``result.history`` (shape
            ``(iterations, n_blocks)``) — the fused-mode replacement for
            the reference's host-side ``Traceback``.
        state: warm-restart state from a previous solve's ``.state``
            (pairs with passing the previous solve's ``X`` iterate, like
            the ADMM family's ``state=``): the Nesterov momentum clock +
            previous iterate, backtracking scales and stepper state
            (e.g. Barzilai–Borwein history, strided-refresh intervals)
            continue, so a killed accelerated solve resumed from a
            checkpoint reproduces the uninterrupted trajectory exactly.
            The iteration counter restarts (up to ``max_iter`` further
            iterations). Round-trips through
            :mod:`proxmin_tpu.checkpoint`. No reference analogue (a
            reference re-call restarts FISTA momentum from scratch).

    Returns:
        ``SolverResult`` unpacking as ``(converged, G, S)`` like the
        reference, with attributes ``.x`` (solution blocks),
        ``.iterations``, ``.converged``, ``.state`` (warm-restart
        pytree).
    """
    x0, originals, was_single = tupleize(X)
    n = len(x0)
    prox = normalize_prox(prox, n)
    e_rel = normalize_per_block(e_rel, n)
    if grad is None:
        # autodiff convenience: differentiate the smooth function itself
        # (the accelerator-native successor of the reference's autograd
        # compatibility, README.md:33)
        assert f is not None, "grad=None requires f"
        from .common import grad_from_f

        grad = grad_from_f(f, n)
    assert backtracking is False or f is not None
    stepper = make_stepper(step, n)

    # driver cache: repeated solves with the same callables/shapes reuse
    # the compiled executable (standard jax.jit contract — callables keyed
    # by identity, closure-captured arrays treated as fixed)
    key = ("pgm", callable_key(grad), _stepper_cache_key(step, stepper),
           tuple(callable_key(p) for p in prox), accelerated,
           bool(restart), backtracking,
           callable_key(f) if f is not None else None, e_rel, max_iter,
           trace, callback is None, abstract_key(x0))

    # large partial-bound data (e.g. nmf's Y/W inside the grad partial)
    # is split out of the callables and passed as jit ARGUMENTS — traced
    # closures embed captured arrays as HLO literal constants, making
    # compile time scale with the data size (and overflowing the remote
    # compiler past ~100 MB). See common.split_partial_data.
    grad_rb, grad_lv = split_partial_data(grad)
    if f is not None:
        f_rb, f_lv = split_partial_data(f)
    else:
        f_rb, f_lv = (lambda lv: None), ()
    prox_pairs = tuple(split_partial_data(p) for p in prox)
    prox_rbs = tuple(pp[0] for pp in prox_pairs)
    prox_lv = tuple(pp[1] for pp in prox_pairs)
    stepper_rb, step_lv = split_stepper_data(step, stepper, n)

    data_leaves = (grad_lv, step_lv, f_lv, prox_lv)

    def _rebuild(leaves):
        g = grad_rb(leaves[0])
        st = stepper_rb(leaves[1])
        ff = f_rb(leaves[2])
        pr = tuple(rb(lv) for rb, lv in zip(prox_rbs, leaves[3]))
        return g, st, ff, pr

    # segmented mode for strided steppers: refresh outside the hot loop
    # (see _run_segmented); iterate-identical, ~2x at the weighted flagship
    use_segmented = (
        getattr(stepper, "segmentable", False)
        and (int(getattr(stepper, "stride", 0) or 0) > 1
             or getattr(stepper, "adapt", False))
    )

    def build():
        def make_body(leaves):
            g, st, ff, pr = _rebuild(leaves)
            body = _make_pgm_body(g, st, pr, e_rel, accelerated,
                                  backtracking, ff, trace=trace,
                                  restart=restart)
            return body, g

        if callback is None:
            # not donated (whether donation pays on the GPU is an open
            # perf question). The final gradient is computed INSIDE the
            # executable (one eval after the loop; see the deviation
            # note below) — eagerly it would compile one op at a time.
            # The initial state is built INSIDE the executable too:
            # building it eagerly dispatches ~a dozen host->device ops
            # per solve
            @jax.jit
            def run(x, leaves, resume):
                g, st, ff, pr = _rebuild(leaves)
                s = _init_state(x, g, st, n, max_iter, trace, accelerated,
                                resume=resume)
                if use_segmented:
                    s = _run_segmented(s, g, st, pr, e_rel, accelerated,
                                       backtracking, ff, trace, max_iter,
                                       n, resuming=resume is not None,
                                       restart=restart)
                else:
                    body = _make_pgm_body(g, st, pr, e_rel, accelerated,
                                          backtracking, ff, trace=trace,
                                          restart=restart)
                    s = _run_fused(s, body, max_iter, n)
                return s, utils._as_tuple(g(*s.x))

            return stepper, run, None

        step_jit = jax.jit(lambda s, leaves: make_body(leaves)[0](s))
        fg_jit = jax.jit(
            lambda s, leaves: utils._as_tuple(make_body(leaves)[1](*s.x))
        )
        return stepper, step_jit, fg_jit

    if cacheable(key):
        cached_stepper, run, final_grad = _PGM_CACHE.get_or_build(key, build)
    else:
        # e.g. a mutable NumPy step array: retrace per call (always
        # correct), mirroring the ADMM/bSDMM drivers' cacheable() bypass
        cached_stepper, run, final_grad = build()

    # Deliberate deviation from the reference: the returned G is the
    # gradient at the RETURNED SOLUTION, evaluated once post-loop. The
    # reference returns grad at the last iteration's extrapolated point
    # (algorithms.py:105) — reproducing that exactly would mean carrying
    # a full-size gradient (or a second iterate) through the while_loop,
    # and every changing full-size carry entry costs a buffer write per
    # iteration (~2x the whole flagship iteration). Iterates are
    # bit-identical to the reference; only this diagnostic differs.
    if callback is None:
        state, G_fin = run(tuple(x0), data_leaves, state)
    else:
        state = _init_state(x0, grad, cached_stepper, n, max_iter, trace,
                            accelerated, resume=state)
        for it in range(max_iter):
            try:
                callback(*[np.asarray(x) for x in state.x], it=it)
            except StopIteration:
                break
            state = run(state, data_leaves)
            if bool(jnp.all(state.converged)) or bool(state.diverged):
                break
        G_fin = final_grad(state, data_leaves)

    # one batched device->host fetch (separate int()/np.asarray() calls
    # pay one transfer round trip EACH)
    it_h, conv_h, div_h = jax.device_get(
        (state.it, state.converged, state.diverged)
    )
    iterations = int(it_h)
    logger.info("Completed %d iterations", iterations)
    converged = tuple(bool(c) for c in conv_h)
    diverged = bool(div_h)
    if diverged:
        status = "diverged"
        logger.warning("Solution diverged (non-finite iterate)")
    elif all(converged):
        status = "converged"
    else:
        status = "max_iter"
        logger.warning("Solution did not converge")

    writeback(originals, state.x)
    x_out = state.x[0] if was_single else state.x
    G = G_fin[0] if was_single else G_fin
    S = state.S[0] if was_single else state.S
    history = np.asarray(state.history[:iterations]) if trace else None
    # warm-restart pytree (plain dict of device arrays like the ADMM
    # family's `.state`): everything a continuation needs beyond the
    # iterate itself
    resume_state = {
        "x_prev": state.x_prev, "t": state.t, "T": state.T,
        "f_prev": state.f_prev, "stepper_state": state.stepper_state,
        "it": state.it + state.it0,
        # terminal flags: a solve that STOPPED (exact fixed point at
        # e_rel=0, tolerance hit, or divergence) must stay stopped on
        # resume — fresh flags would take extra steps the uninterrupted
        # run never took (r4 extended-fuzz finding: FISTA+backtracking
        # parked exactly on 0 for one iteration, stopped converged, and
        # the resumed run moved off it)
        "converged": state.converged, "diverged": state.diverged,
    }
    return SolverResult(
        (converged, G, S),
        x=x_out, iterations=iterations, converged=converged, G=G, S=S,
        history=history, status=status, state=resume_state,
    )
