"""Linearized ADMM and SDMM — jit-compiled while-loop drivers.

accelerator-native re-design of the reference ``admm`` / ``sdmm``
(``proxmin/algorithms.py:426-650``; Moolekamp & Melchior
Algorithms 1-2, arXiv:1708.09066; Parikh & Boyd 2014 linearized ADMM):
two-prox splitting with a linear operator inside g, extended to M
simultaneous constraints, with Boyd (2011) §3.3.1 primal/dual residual
stopping and the reference's slack-halving **restart heuristic** when the
iterate and primal residual stall.

The restart (reference ``algorithms.py:504-514``) is expressed as carry
logic: when ``X == X_prev`` and ``R == R_prev`` element-wise, the step
slack halves, the iteration counter resets to 0 and Z/U re-initialize —
all inside the ``lax.while_loop``. Because resetting ``it`` could loop
forever, a total-work counter bounds the solve at ``8 * max_iter`` body
evaluations (the reference has no such guard and can spin indefinitely;
slack halving makes progress so the bound is generous).
"""

import logging
from typing import Any, NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from .. import utils
from ..linop import as_linear_operator
from .common import (
    BoolResult,
    DriverCache,
    SolverResult,
    abstract_key,
    cacheable,
    split_partial_data,
    callable_key,
    nested_key,
    status_from,
    tupleize,
    value_key,
    writeback,
)

logger = logging.getLogger("proxmin")

__all__ = ["admm", "sdmm"]

_RESTART_BUDGET = 8  # total body evaluations allowed: budget * max_iter

# residual-balancing multiplier bounds (adapt_step mode): wide enough to
# correct any plausible step mis-scaling, tight enough that a stuck
# imbalance cannot compound into float overflow/underflow
_ADAPT_SCALE_MIN = 2.0 ** -20
_ADAPT_SCALE_MAX = 2.0 ** 20

_ADMM_CACHE = DriverCache()


def _as_step_fn(step):
    """ADMM-family step convention: ``step_f(X, it=it) -> float``
    (reference ``algorithms.py:482``); floats are wrapped."""
    if callable(step):
        return step
    return lambda X, it=None: step


class ADMMState(NamedTuple):
    x: Any
    z: Any               # tuple of M (or single) aux variables
    u: Any               # duals, same structure as z
    it: Any
    total_it: Any
    slack: Any
    converged: Any
    errors: Any          # (M, 4) array: e_pri, e_dual, |R|, |S| per constraint
    r_prev: Any          # same structure as z
    history: Any         # (cap, M, 4) residual trace indexed by total_it
                         # (restarts keep appending; empty when trace off)
    step_scale: Any      # residual-balancing multiplier on step_f
                         # (adapt_step mode; pinned 1.0 otherwise)
    total_it0: Any       # carried global step count at warm restart (0
                         # fresh): history indexes locally via
                         # total_it - total_it0
    it0: Any             # carried `it` clock at warm restart (0 fresh):
                         # the restart-resettable `it` continues, so the
                         # stop bound becomes it0 + max_iter — the same
                         # value the uninterrupted solve uses — and the
                         # stall detector sees the true clock
    diverged: Any        # bool — non-finite residual errors were produced
                         # (failure detection, SURVEY.md §5: same early
                         # stop + structured status as pgm/adaprox; a NaN
                         # or Inf iterate poisons ||Lx||/||R||/||S|| in
                         # errors, so no extra pass over x is needed)


def _stack_errors(errors, multi):
    """(e_pri, e_dual, |R|, |S|) per constraint -> (M, 4) array."""
    if not multi:
        errors = (errors,)
    return jnp.stack([
        jnp.stack([jnp.asarray(v, jnp.result_type(float)) for v in e])
        for e in errors
    ])


def _resume_state(state):
    """Extract the warm-restart pytree from a final ADMMState — the
    fields that continue across a checkpoint/resume boundary (plain dict
    of arrays: serializes through ``proxmin_tpu.checkpoint`` as-is)."""
    return {
        "z": state.z, "u": state.u, "slack": state.slack,
        "step_scale": state.step_scale, "r_prev": state.r_prev,
        "it": state.it, "total_it": state.total_it,
        # terminal flags: a stopped solve stays stopped on resume (see
        # pgm's resume_state note)
        "converged": state.converged, "diverged": state.diverged,
    }


def _sdmm_core(
    x0, prox_f, step_f, proxs_g, steps_g, Ls, e_rel, e_abs, max_iter,
    callback, return_errors, trace=False, admm_convention=True,
    cache_key=None, retain_refs=(), return_runner=False, adapt_step=False,
    resume=None,
):
    """Shared driver. ``proxs_g``: tuple of M callables (possibly empty for
    the no-constraint fallback); ``steps_g``: tuple of M (user values or
    None); ``Ls``: tuple of M LinearOperators.

    ``admm_convention``: reference admm passes the USER step_g (None when
    defaulted) to the convergence test (``algorithms.py:495``) while
    reference sdmm passes the evaluated value (``algorithms.py:625``);
    the flag selects which convention the single-constraint branch keeps.

    ``adapt_step``: Boyd (2011) §3.4.1 residual balancing — when the
    primal residual dominates (``||R|| > 10 ||S||``) the penalty rises,
    i.e. the f-prox step SHRINKS by 2 (steps here are ~1/rho); when the
    dual dominates it grows by 2; the scaled duals U rescale by the same
    factor so the underlying multiplier ``y = U / step_g`` is continuous
    (without the rescale the first adapted iteration takes a spurious
    jump). The reference defines this adaptation (``utils.py:282-292``)
    but never calls it — and with the opposite sign, which for
    prox steps ~ 1/rho drives the residual imbalance FURTHER; see
    ``tests/test_admm_sdmm.py`` for the measured iteration counts.
    Requires DERIVED ``step_g`` (the ``step_f * ||L||^2`` coupling): a
    fixed user ``step_g`` would not track the adapted ``step_f``, so
    the dual rescale corrupts ``y`` and ``step_f`` can cross the
    linearized-ADMM stability bound ``step_f <= step_g / ||L||^2``
    (measured: NaN divergence) — callers reject that combination.
    """
    M = len(proxs_g)
    has_g = M > 0
    if adapt_step and any(sg is not None for sg in steps_g):
        raise ValueError(
            "adapt_step requires the derived step_g coupling "
            "(step_g=None): a fixed user step_g cannot track the "
            "adapted step_f, which corrupts the dual rescale and can "
            "cross the linearized-ADMM stability bound"
        )

    L_struct = list(Ls) if M != 1 else (Ls[0] if has_g else None)

    def init_zu(x):
        if not has_g:
            return x, jnp.zeros_like(x)
        return utils.initZU(x, L_struct)

    # large partial-bound data (and the operator pytrees, whose matrices
    # can be big) ride as jit arguments, not trace constants — see
    # common.split_partial_data
    pf_rb, pf_lv = split_partial_data(prox_f)
    if callable(step_f):
        sf_rb, sf_lv = split_partial_data(step_f)
    else:
        sf_rb, sf_lv = (lambda lv, _v=step_f: _v), ()
    pg_pairs = tuple(split_partial_data(p) for p in proxs_g)
    pg_rbs = tuple(pp[0] for pp in pg_pairs)
    data_leaves = (pf_lv, sf_lv, tuple(pp[1] for pp in pg_pairs),
                   tuple(Ls))

    def make_body(leaves):
        prox_f = pf_rb(leaves[0])
        step_fn = _as_step_fn(sf_rb(leaves[1]))
        proxs_g = tuple(rb(lv) for rb, lv in zip(pg_rbs, leaves[2]))
        Ls = tuple(leaves[3])
        L_struct = list(Ls) if M != 1 else (Ls[0] if has_g else None)

        def init_zu(x):
            if not has_g:
                return x, jnp.zeros_like(x)
            return utils.initZU(x, L_struct)

        def body(state: ADMMState) -> ADMMState:
            it = state.it
            step_f_ = state.slack * step_fn(state.x, it=it)
            if adapt_step:
                step_f_ = step_f_ * state.step_scale

            if has_g:
                if M == 1:
                    sg = steps_g[0]
                    step_g_ = (
                        utils.get_step_g(step_f_, Ls[0].spectral_norm_sq)
                        if sg is None else sg
                    )
                    x, z, u, lx, r, s = utils.update_variables(
                        state.x, state.z, state.u, prox_f, step_f_,
                        proxs_g[0], step_g_, Ls[0],
                    )
                    conv_sg = sg if admm_convention else step_g_
                    conv, errors = utils.check_constraint_convergence(
                        x, Ls[0], lx, z, u, r, s, step_f_, conv_sg, e_rel, e_abs
                    )
                else:
                    steps_g_ = tuple(
                        utils.get_step_g(step_f_, Ls[i].spectral_norm_sq, M=M)
                        if steps_g[i] is None else steps_g[i]
                        for i in range(M)
                    )
                    x, z, u, lx, r, s = utils.update_variables(
                        state.x, list(state.z), list(state.u), prox_f, step_f_,
                        list(proxs_g), list(steps_g_), list(Ls),
                    )
                    conv, errors = utils.check_constraint_convergence(
                        x, list(Ls), list(lx), list(z), list(u), list(r),
                        list(s), step_f_, list(steps_g_), e_rel, e_abs,
                    )
            else:
                ident = as_linear_operator(None)
                x, z, u, lx, r, s = utils.update_variables(
                    state.x, state.z, state.u, prox_f, step_f_, None, None, ident
                )
                conv, errors = utils.check_constraint_convergence(
                    x, ident, lx, z, u, r, s, step_f_, None, e_rel, e_abs
                )

            it = it + 1
            errors_arr = _stack_errors(errors, M > 1)
            # failure detection: the error tuple's norms are reductions
            # of every live quantity (lx, z, u, r, s), so their
            # finiteness detects a diverged iterate for free
            diverged = jnp.logical_or(
                state.diverged,
                jnp.logical_not(jnp.all(jnp.isfinite(errors_arr))),
            )
            history = state.history
            if trace:
                # the buffer holds 2*max_iter rows (not the full
                # 8*max_iter restart budget — a 4x memory saving);
                # restart storms beyond that overwrite the last row,
                # which the clamp below makes safe (an out-of-bounds
                # .at[].set would silently drop instead)
                idx = jnp.minimum(state.total_it - state.total_it0,
                                  history.shape[0] - 1)
                history = history.at[idx].set(
                    errors_arr.astype(history.dtype)
                )

            # residual balancing (Boyd §3.4.1): compare aggregate primal
            # vs dual residual norms; adjust the step multiplier for the
            # NEXT iteration and rescale the scaled duals to keep the
            # multiplier y = U / step_g continuous
            if adapt_step and has_g:
                lR = jnp.sqrt(jnp.sum(errors_arr[:, 2] ** 2))
                lS = jnp.sqrt(jnp.sum(errors_arr[:, 3] ** 2))
                mu, tau = 10.0, 2.0
                ratio = jnp.where(
                    lR > mu * lS, 1.0 / tau,
                    jnp.where(lS > mu * lR, tau, 1.0),
                )
                # bounded multiplier: a persistently one-sided residual
                # imbalance would otherwise compound 2x per iteration
                # into overflow/underflow before max_iter trips (Boyd
                # implementations bound rho the same way). The dual
                # rescale uses the EFFECTIVE ratio so the multiplier
                # y = U / step_g stays continuous even at the clamp.
                step_scale = jnp.clip(
                    state.step_scale * ratio,
                    _ADAPT_SCALE_MIN, _ADAPT_SCALE_MAX,
                )
                ratio_eff = step_scale / state.step_scale
                u = jax.tree_util.tree_map(lambda ui: ui * ratio_eff, u)
            else:
                step_scale = state.step_scale

            # stall detector (reference algorithms.py:504-514 / 634-641):
            # X and primal residual unchanged since last iteration -> halve the
            # slack, reset the iteration counter, re-initialize Z and U
            if has_g:
                # state.x at body entry IS the previous iterate — no
                # separate x_prev carry slot needed (a full-size slot
                # that changes per iteration costs a buffer write)
                same_x = jnp.all(x == state.x)
                if M == 1:
                    same_r = jnp.all(r == state.r_prev)
                else:
                    same_r = jnp.asarray(True)
                    for i in range(M):
                        same_r = jnp.logical_and(same_r, jnp.all(r[i] == state.r_prev[i]))
                restart = jnp.logical_and(
                    it > 1, jnp.logical_and(same_x, same_r)
                )
                restart = jnp.logical_and(restart, jnp.logical_not(conv))

                z_init, u_init = init_zu(x)
                slack = jnp.where(restart, state.slack / 2, state.slack)
                it = jnp.where(restart, 0, it)
                pick = lambda a, b: jax.tree_util.tree_map(
                    lambda ai, bi: jnp.where(restart, ai, bi), a, b
                )
                z = pick(z_init, z)
                u = pick(u_init, u)
            else:
                slack = state.slack

            return ADMMState(
                x=x, z=z, u=u, it=it, total_it=state.total_it + 1,
                slack=slack, converged=conv, errors=errors_arr,
                r_prev=r, history=history, step_scale=step_scale,
                total_it0=state.total_it0, it0=state.it0,
                diverged=diverged,
            )

        return body, init_zu
    def init_state(x, init_zu=init_zu, resume=None):
        if resume is None:
            z0, u0 = init_zu(x)
            slack0 = jnp.asarray(1.0, x.dtype)
            scale0 = jnp.asarray(1.0, x.dtype)
            if has_g and M == 1:
                r0 = jnp.zeros_like(z0)
            elif has_g:
                r0 = tuple(jnp.zeros_like(zi) for zi in z0)
            else:
                r0 = jnp.zeros_like(x)
        else:
            # warm restart (checkpoint/resume): Z/U, the slack, the
            # residual-balancing multiplier, the stall-detector residual
            # AND the iteration clocks all continue — the `it` clock is
            # restart-resettable (the stall detector's `it > 1` guard
            # and the `it < bound` stop both key on it), so only
            # carrying it walks the uninterrupted trajectory exactly;
            # `max_iter` still means "this many further steps" via the
            # total_it0-shifted bounds. (The reference's ADMM family has
            # no continuation at all: algorithms.py:471 re-inits Z, U.)
            z0 = resume["z"]
            u0 = resume["u"]
            slack0 = jnp.asarray(resume["slack"], x.dtype)
            scale0 = jnp.asarray(resume["step_scale"], x.dtype)
            r0 = resume["r_prev"]
        it0 = (jnp.asarray(resume.get("it", 0), jnp.int32)
               if resume is not None else jnp.int32(0))
        tot0 = (jnp.asarray(resume.get("total_it", 0), jnp.int32)
                if resume is not None else jnp.int32(0))
        conv0 = (jnp.asarray(resume.get("converged", False), bool)
                 if resume is not None else jnp.asarray(False))
        div0 = (jnp.asarray(resume.get("diverged", False), bool)
                if resume is not None else jnp.asarray(False))
        return ADMMState(
            x=jnp.array(x, copy=True),
            z=jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), z0),
            u=jax.tree_util.tree_map(jnp.asarray, u0),
            it=it0,
            total_it=tot0,
            slack=slack0,
            converged=conv0,
            errors=jnp.zeros((max(M, 1), 4)),
            r_prev=jax.tree_util.tree_map(jnp.asarray, r0),
            history=jnp.zeros((2 * max_iter if trace else 0, max(M, 1), 4)),
            step_scale=scale0,
            total_it0=tot0,
            it0=it0,
            diverged=div0,
        )

    def _cond(s):
        # bound on the carried restart-relative clock: it0 + max_iter is
        # the SAME bound value the uninterrupted solve runs under (its
        # max_iter equals it0 + the further steps requested here), so
        # restart-extended runs continue identically; fresh solves have
        # it0 == 0 and the original bounds. The total-work cap scales
        # from the same equivalent max_iter.
        lim = s.it0 + max_iter
        return jnp.logical_and(
            jnp.logical_and(s.it < lim,
                            s.total_it < s.total_it0
                            + _RESTART_BUDGET * max_iter),
            jnp.logical_and(jnp.logical_not(s.converged),
                            jnp.logical_not(s.diverged)),
        )


    if return_runner:
        # AOT-export path (export.py): a pure ``x0 -> final state`` function
        # with the data leaves baked as trace constants (artifacts are
        # per-dataset, like the pgm/adaprox exports)
        body, _ = make_body(data_leaves)

        def runner(x):
            return jax.lax.while_loop(_cond, body, init_state(x))

        return runner

    def build():
        if callback is None:
            # initial state built INSIDE the executable, from the
            # leaves-rebuilt operators (eager construction dispatches
            # several host->device ops per solve; see the pgm driver)
            def run(x, leaves, resume):
                body, init_zu_l = make_body(leaves)
                state = init_state(x, init_zu=init_zu_l, resume=resume)
                return jax.lax.while_loop(_cond, body, state)

            # not donated, like the pgm driver
            compiled = jax.jit(run)
        else:
            compiled = jax.jit(lambda s, leaves: make_body(leaves)[0](s))
        # retain_refs keeps the cache-key objects (user L matrices etc.)
        # alive so their ids cannot be recycled while the entry exists
        return compiled, retain_refs

    # mutable NumPy data in the key -> bypass the cache (id-keying could
    # serve a stale trace after in-place mutation; retrace-per-call is
    # always correct)
    if cache_key is None or not cacheable(cache_key):
        compiled, _ = build()
    else:
        compiled, _ = _ADMM_CACHE.get_or_build(
            cache_key + (callback is None, max_iter, trace), build
        )

    if callback is None:
        state = compiled(x0, data_leaves, resume)
    else:
        state = init_state(x0, resume=resume)
        while bool(_cond(state)):
            try:
                callback(np.asarray(state.x), it=int(state.it))
            except StopIteration:
                break
            state = compiled(state, data_leaves)

    return state


@utils.with_matmul_precision
def admm(
    X,
    prox_f,
    step_f,
    prox_g=None,
    step_g=None,
    L=None,
    e_rel=1e-6,
    e_abs=0,
    max_iter=1000,
    callback=None,
    trace=False,
    adapt_step=False,
    state=None,
):
    """Linearized Alternating Direction Method of Multipliers.

    Drop-in equivalent of the reference ``proxmin.admm``
    (``algorithms.py:426-520``): minimizes ``f(x) + g(L x)`` for two
    proxable functions, with ``step_g`` defaulting to
    ``step_f * ||L||_s^2`` and the stall-restart heuristic.

    ``adapt_step=True`` enables Boyd §3.4.1 residual balancing with dual
    rescaling (see ``_sdmm_core``): a mis-scaled ``step_f`` is corrected
    on the fly by comparing primal/dual residual norms, typically a
    large iteration-count win when the good step is not known a priori.
    The reference defines this adaptation but never wires it
    (``utils.py:282-292``).

    ``state``: warm-restart state from a previous solve's ``.state``
    attribute (checkpointable via :mod:`proxmin_tpu.checkpoint`): the
    Z/U splitting variables, step slack, residual-balancing multiplier
    and stall-detector residual continue where the previous solve
    stopped — the ADMM-family analogue of adaprox's M/V/Vhat warm start
    (the reference always re-inits Z, U: ``algorithms.py:471``). Resume
    with the previous solve's ``X`` iterate; a resumed solve runs up to
    ``max_iter`` further iterations.

    Returns:
        ``SolverResult`` unpacking as ``(converged, error)`` with
        attributes ``.x``, ``.iterations``, ``.slack``, ``.errors``,
        ``.state`` (warm-restart pytree).
    """
    (x0,), originals, _ = tupleize(X)
    Lop = as_linear_operator(L)
    proxs_g = (prox_g,) if prox_g is not None else ()
    steps_g = (step_g,) if prox_g is not None else ()

    cache_key = (
        "admm", callable_key(prox_f),
        callable_key(step_f) if callable(step_f) else value_key(step_f),
        callable_key(prox_g) if prox_g is not None else None,
        value_key(step_g), value_key(L), float(e_rel), float(e_abs),
        bool(adapt_step), abstract_key((x0,)),
    )
    state = _sdmm_core(
        x0, prox_f, step_f, proxs_g, steps_g, (Lop,) if prox_g is not None else (),
        e_rel, e_abs, max_iter, callback, return_errors=True, trace=trace,
        cache_key=cache_key, retain_refs=(prox_f, step_f, prox_g, L),
        adapt_step=adapt_step, resume=state,
    )

    # one batched device->host fetch (each round trip costs a sync)
    conv_h, it_h, err_h, slack_h, tot_h, tot0_h, div_h = jax.device_get(
        (state.converged, state.it, state.errors, state.slack,
         state.total_it, state.total_it0, state.diverged)
    )
    converged = bool(conv_h)
    diverged = bool(div_h)
    # fresh solves report the reference's restart-relative counter;
    # resumed solves report THIS CALL's steps (restarts included) —
    # the continued restart-relative `it` would overcount the call
    this_call = int(tot_h) - int(tot0_h)
    iterations = int(it_h) if int(tot0_h) == 0 else this_call
    logger.info("Completed %d iterations", iterations)
    status = status_from(converged, diverged, logger)

    errors = tuple(float(v) for v in err_h[0])
    history = (np.asarray(state.history[:min(this_call,
                                             state.history.shape[0])])
               if trace else None)
    writeback(originals, (state.x,))
    return SolverResult(
        (converged, errors),
        x=state.x, iterations=iterations, converged=converged,
        errors=errors, slack=float(slack_h),
        total_iterations=this_call, history=history, status=status,
        state=_resume_state(state),
    )


@utils.with_matmul_precision
def sdmm(
    X,
    prox_f,
    step_f,
    proxs_g=None,
    steps_g=None,
    Ls=None,
    e_rel=1e-6,
    e_abs=0,
    max_iter=1000,
    callback=None,
    trace=False,
    adapt_step=False,
    state=None,
):
    """Simultaneous-Direction Method of Multipliers (M constraints).

    Drop-in equivalent of the reference ``proxmin.sdmm``
    (``algorithms.py:523-650``): linearized ADMM extended to a list of
    constraints ``proxs_g = [g_1 .. g_M]`` each with its own linear
    operator ``Ls[i]``; falls back to :func:`admm` when ``proxs_g`` is not
    a list (reference ``algorithms.py:568-579``).

    Returns:
        ``BoolResult`` — truthy iff converged (the reference returns the
        bare flag, ``algorithms.py:650``) with attributes ``.x``,
        ``.iterations``, ``.errors``.

    Deliberate deviation from the reference: the single-constraint
    fallback forwards ``e_abs`` to :func:`admm`, whereas the reference
    silently drops it in that branch (``algorithms.py:568-579``) so
    ``sdmm(..., proxs_g=<single prox>, e_abs>0)`` stops on a different
    criterion than the M=1 list form. Here the scalar and the
    one-element-list spellings converge identically (pinned by
    ``test_sdmm_scalar_fallback_honors_e_abs``).
    """
    if proxs_g is None or not hasattr(proxs_g, "__iter__"):
        return admm(
            X, prox_f, step_f, prox_g=proxs_g, step_g=steps_g, L=Ls,
            e_rel=e_rel, e_abs=e_abs, max_iter=max_iter, callback=callback,
            trace=trace, adapt_step=adapt_step, state=state,
        )

    (x0,), originals, _ = tupleize(X)
    M = len(proxs_g)
    if not hasattr(Ls, "__iter__"):
        Ls = [Ls] * M
    assert len(Ls) == M
    Lops = tuple(as_linear_operator(Li) for Li in Ls)
    if steps_g is None:
        steps_g = (None,) * M
    else:
        assert len(steps_g) == M
        steps_g = tuple(steps_g)

    cache_key = (
        "sdmm", callable_key(prox_f),
        callable_key(step_f) if callable(step_f) else value_key(step_f),
        tuple(callable_key(p) for p in proxs_g),
        nested_key(tuple(steps_g)),
        nested_key(tuple(Ls)),
        float(e_rel), float(e_abs), bool(adapt_step), abstract_key((x0,)),
    )
    state = _sdmm_core(
        x0, prox_f, step_f, tuple(proxs_g), steps_g, Lops,
        e_rel, e_abs, max_iter, callback, return_errors=False, trace=trace,
        admm_convention=False,
        cache_key=cache_key,
        retain_refs=(prox_f, step_f, tuple(proxs_g), tuple(Ls), steps_g),
        adapt_step=adapt_step, resume=state,
    )

    conv_h, it_h, err_h, slack_h, tot_h, tot0_h, div_h = jax.device_get(
        (state.converged, state.it, state.errors, state.slack,
         state.total_it, state.total_it0, state.diverged)
    )
    converged = bool(conv_h)
    diverged = bool(div_h)
    # fresh solves report the reference's restart-relative counter;
    # resumed solves report THIS CALL's steps (restarts included) —
    # the continued restart-relative `it` would overcount the call
    this_call = int(tot_h) - int(tot0_h)
    iterations = int(it_h) if int(tot0_h) == 0 else this_call
    logger.info("Completed %d iterations", iterations)
    status = status_from(converged, diverged, logger)

    errors = tuple(
        tuple(float(v) for v in row) for row in err_h
    )
    history = (np.asarray(state.history[:min(this_call,
                                             state.history.shape[0])])
               if trace else None)
    writeback(originals, (state.x,))
    return BoolResult(
        converged,
        x=state.x, iterations=iterations, converged=converged,
        errors=errors, slack=float(slack_h),
        total_iterations=this_call, history=history, status=status,
        state=_resume_state(state),
    )
