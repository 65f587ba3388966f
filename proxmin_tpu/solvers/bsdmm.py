"""Block-Simultaneous Method of Multipliers (bSDMM) — jit-compiled driver.

accelerator-native re-design of the reference ``bsdmm`` (``proxmin/
algorithms.py:653-850``; Moolekamp & Melchior Algorithm 3,
arXiv:1708.09066): linearized SDMM extended to N variable blocks with a
Gauss–Seidel sweep in ``update_order``, each block carrying its own list of
M_j constraints, proxs and linear operators, with per-block Boyd residual
convergence.

jit requires static pytree structure, so the (possibly ragged) nested
constraint lists ``proxs_g[j][i]`` / ``Ls[j][i]`` are normalized to static
tuples at trace time — the constraint topology is fixed per problem, so
this costs one compile per topology (SURVEY.md §7 "bSDMM's ragged
structure"). The Gauss–Seidel propagation (block j's ``prox_f`` sees the
already-updated blocks of the current sweep, reference
``algorithms.py:806``) is preserved by threading the updated block list
through the sweep inside the loop body.

Reference-bug fix: ``steps_g_update='relative'`` divides by the previous
sweep's ``steps_f[j]`` which is ``None`` on the first sweep (reference
``algorithms.py:810-812`` — TypeError if ever exercised); here the first
sweep skips the rescale.
"""

import logging
from typing import Any, NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from .. import utils
from ..linop import as_linear_operator
from .common import (
    DriverCache,
    SolverResult,
    abstract_key,
    cacheable,
    callable_key,
    nested_key,
    split_partial_data,
    status_from,
    tupleize,
    writeback,
)

logger = logging.getLogger("proxmin")

__all__ = ["bsdmm"]

_BSDMM_CACHE = DriverCache()


class BSDMMState(NamedTuple):
    x: tuple             # N blocks
    z: tuple             # per block: tuple of M_j (or single aux)
    u: tuple
    steps_f: Any         # (N,) last step_f per block
    steps_g: tuple       # per block: tuple of M_j scalars (carried for 'relative')
    steps_state: Any     # stateful steps_f_cb carry (e.g. the warm-start
                         # power iterate of nmf.WeightedBSDMMStepper);
                         # () for plain callables
    it: Any
    converged: Any       # (N,) bool
    history: Any         # (max_iter, N, 2) per-block aggregated primal/dual
                         # residual norms (trace mode; empty otherwise)
    it0: Any             # carried sweep count at warm restart (0 fresh):
                         # the sweep clock continues, so stepper refresh
                         # schedules (`it >= nxt`, `it % stride == 0`)
                         # stay on the uninterrupted phase; history and
                         # the max_iter bound index locally via it - it0
    diverged: Any        # bool — non-finite residual errors were produced
                         # (failure detection, SURVEY.md §5: early stop +
                         # structured status like pgm/adaprox; a NaN/Inf
                         # block iterate poisons the per-block error norms)


class _BsdmmProgram(NamedTuple):
    """The pure pieces of a bsdmm solve, shared by the host driver, the
    AOT exporter and :func:`proxmin_tpu.functional.make_bsdmm_solver`
    (so the factory cannot drift from the in-process semantics):
    ``make_body(leaves) -> (body, init_zu)``, ``make_loop(leaves) ->
    (loop, init_zu)`` (the full while-loop, segmented when the stepper
    opts in), ``init_state(xs, init_zu=...) -> BSDMMState``, the
    partial-bound ``data_leaves`` to pass/bake, and the driver-cache
    ingredients."""

    make_body: Any
    make_loop: Any
    init_state: Any
    data_leaves: Any
    cond: Any
    stateful_steps: bool


def _build_bsdmm(n_blocks, dtype, proxs_f, steps_f_cb, proxs_g=None,
                 steps_g=None, Ls=None, update_order=None,
                 steps_g_update="steps_f", e_rel=1e-6, e_abs=0,
                 max_iter=1000, steps_f_stride=None, trace=False):
    """Normalize the nested constraint structure and build the pure
    pieces of a bsdmm solve (see :class:`_BsdmmProgram`). Shared by the
    host driver below, the AOT exporter and
    :func:`proxmin_tpu.functional.make_bsdmm_solver` — one body builder,
    zero drift. Only the block COUNT and dtype are needed, not the block
    arrays, so the factory can call this from inside a trace without
    touching the host driver."""
    N = n_blocks
    if proxs_g is None:
        proxs_g = [None] * N
    proxs_g = list(proxs_g)
    assert len(proxs_g) == N
    steps_g_update = steps_g_update.lower()
    assert steps_g_update in ("steps_f", "fixed", "relative")

    e_rel = [e_rel] * N if np.isscalar(e_rel) else list(e_rel)
    e_abs = [e_abs] * N if np.isscalar(e_abs) else list(e_abs)
    assert len(e_rel) == N and len(e_abs) == N

    if update_order is None:
        update_order = tuple(range(N))
    else:
        update_order = tuple(int(j) for j in update_order)

    if steps_g_update == "steps_f" and steps_g is not None:
        logger.debug("Setting steps_g = None for update strategy 'steps_f'.")
        steps_g = None
    if steps_g_update in ("fixed", "relative") and steps_g is None:
        logger.debug(
            "Ignoring steps_g update strategy %r because steps_g is None.",
            steps_g_update,
        )
        steps_g_update = "steps_f"

    # normalize nested structures: steps_g[j][i], Ls[j][i]
    if not hasattr(steps_g, "__iter__"):
        steps_g = [steps_g] * N
    if not hasattr(Ls, "__iter__"):
        Ls = [Ls] * N
    steps_g = list(steps_g)
    Ls = list(Ls)
    assert len(steps_g) == N and len(Ls) == N

    M = [0] * N
    for j in range(N):
        if proxs_g[j] is not None:
            if not hasattr(proxs_g[j], "__iter__"):
                proxs_g[j] = [proxs_g[j]]
            proxs_g[j] = tuple(proxs_g[j])
            M[j] = len(proxs_g[j])
            if not hasattr(steps_g[j], "__iter__"):
                steps_g[j] = [steps_g[j]] * M[j]
            if not hasattr(Ls[j], "__iter__"):
                Ls[j] = [Ls[j]] * M[j]
            steps_g[j] = tuple(steps_g[j])
            Ls[j] = tuple(as_linear_operator(Li) for Li in Ls[j])
            assert len(steps_g[j]) == M[j] and len(Ls[j]) == M[j]
        else:
            Ls[j] = as_linear_operator(None)

    has_g = tuple(M[j] > 0 for j in range(N))

    def make_init_zu(Ls_):
        def init_zu(x):
            Z, U = [], []
            for j in range(N):
                if has_g[j]:
                    Zj, Uj = utils.initZU(x[j], list(Ls_[j]))
                    Z.append(tuple(jnp.array(z, copy=True) for z in Zj))
                    U.append(tuple(Uj))
                else:
                    Z.append(jnp.array(x[j], copy=True))
                    U.append(jnp.zeros_like(x[j]))
            return tuple(Z), tuple(U)
        return init_zu

    init_zu = make_init_zu(Ls)

    def init_steps_g():
        out = []
        for j in range(N):
            if has_g[j] and steps_g[j][0] is not None:
                out.append(tuple(jnp.asarray(s, dtype) for s in steps_g[j]))
            elif has_g[j]:
                out.append(tuple(jnp.asarray(0.0, dtype) for _ in range(M[j])))
            else:
                out.append(())
        return tuple(out)

    # stateful steps_f_cb protocol (duck-typed): an object with
    # ``init_bsdmm_state(xs)`` carries per-solve state through the sweep
    # (e.g. nmf.WeightedBSDMMStepper's warm-start power iterate) and is
    # called as ``steps_f_cb(Xs, j=, state=, it=, cached=) ->
    # (step_j, state)``; it handles its own stride logic, so
    # ``steps_f_stride`` must not also be set.
    stateful_steps = hasattr(steps_f_cb, "init_bsdmm_state")
    assert not (stateful_steps and steps_f_stride), \
        "stateful steps_f_cb handles striding itself"

    # large partial-bound data (and operator pytrees) ride as jit
    # arguments, not trace constants — see common.split_partial_data
    pf_rb, pf_lv = split_partial_data(proxs_f)
    if hasattr(steps_f_cb, "split_data"):
        sf_rb, sf_lv = steps_f_cb.split_data()
    else:
        sf_rb, sf_lv = split_partial_data(steps_f_cb)
    pg_pairs = [
        tuple(split_partial_data(p) for p in (proxs_g[j] or ()))
        for j in range(N)
    ]
    data_leaves = (
        pf_lv, sf_lv,
        tuple(tuple(pp[1] for pp in pg_pairs[j]) for j in range(N)),
        tuple(Ls),
    )

    def make_body(leaves, frozen=False):
        """``frozen=True`` builds the mid-segment body: the stepper is
        never called — every block uses its carried step — so the
        segmented inner loop carries no stepper state (the warm-start
        power iterate etc. stays in the outer carry, and no per-block
        refresh ``lax.cond`` runs in the hot loop)."""
        proxs_f = pf_rb(leaves[0])
        steps_f_cb = sf_rb(leaves[1])
        proxs_g_l = [
            tuple(pp[0](lv) for pp, lv in zip(pg_pairs[j], leaves[2][j]))
            if has_g[j] else None
            for j in range(N)
        ]
        proxs_g = proxs_g_l
        Ls = list(leaves[3])
        init_zu_l = make_init_zu(Ls)

        def body(state: BSDMMState) -> BSDMMState:
            it = state.it
            x = list(state.x)
            z = list(state.z)
            u = list(state.u)
            steps_f_arr = state.steps_f
            steps_g_carry = list(state.steps_g)
            steps_state = state.steps_state
            converged = state.converged
            diverged = state.diverged
            history = state.history

            for j in update_order:
                # block prox sees ALL current blocks (Gauss-Seidel propagation)
                xs_now = tuple(x)

                def prox_f_j(v, s, _j=j, _xs=xs_now):
                    return proxs_f(v, s, Xs=_xs, j=_j)

                # slack is identically 1.0 in the reference (never updated,
                # algorithms.py:794)
                if frozen:
                    # mid-segment: no block is due a refresh (the
                    # segment boundary is min over blocks of the next
                    # refresh), so the carried step IS the value the
                    # per-block cond would have returned
                    steps_f_j = steps_f_arr[j]
                elif stateful_steps:
                    steps_f_j, steps_state = steps_f_cb(
                        xs_now, j=j, state=steps_state,
                        it=it, cached=steps_f_arr[j],
                    )
                elif steps_f_stride is not None and steps_f_stride > 1:
                    # strided refresh: the expensive step callable runs only
                    # every steps_f_stride sweeps; between refreshes the
                    # carried (safety-shrunk) step is reused
                    steps_f_j = jax.lax.cond(
                        it % steps_f_stride == 0,
                        lambda _xs=xs_now, _j=j: 0.9 * jnp.asarray(
                            steps_f_cb(_xs, j=_j), dtype),
                        lambda _j=j: steps_f_arr[_j],
                    )
                else:
                    steps_f_j = steps_f_cb(xs_now, j=j)

                if has_g[j]:
                    if steps_g_update == "relative":
                        # rescale carried steps_g by the step_f change; skipped
                        # on the first sweep (reference divides by None there)
                        prev = steps_f_arr[j]
                        scale = jnp.where(it > 0, steps_f_j / prev, 1.0)
                        steps_g_carry[j] = tuple(
                            s * scale for s in steps_g_carry[j]
                        )
                    if steps_g_update == "steps_f":
                        steps_g_j = tuple(
                            utils.get_step_g(
                                steps_f_j, Ls[j][i].spectral_norm_sq, N=N, M=M[j]
                            )
                            for i in range(M[j])
                        )
                    else:
                        steps_g_j = steps_g_carry[j]

                    xj, zj, uj, lxj, rj, sj = utils.update_variables(
                        x[j], list(z[j]), list(u[j]), prox_f_j, steps_f_j,
                        list(proxs_g[j]), list(steps_g_j), list(Ls[j]),
                    )
                    conv_j, err_j = utils.check_constraint_convergence(
                        xj, list(Ls[j]), list(lxj), list(zj), list(uj),
                        list(rj), list(sj), steps_f_j, list(steps_g_j),
                        e_rel[j], e_abs[j],
                    )
                    err_list = err_j
                else:
                    xj, zj, uj, lxj, rj, sj = utils.update_variables(
                        x[j], z[j], u[j], prox_f_j, steps_f_j, None, None, Ls[j]
                    )
                    conv_j, err_j = utils.check_constraint_convergence(
                        xj, Ls[j], lxj, zj, uj, rj, sj, steps_f_j, None,
                        e_rel[j], e_abs[j],
                    )
                    err_list = (err_j,)

                # failure detection: the per-block error norms cover
                # every live quantity, so their finiteness detects a
                # diverged block iterate for free
                diverged = jnp.logical_or(
                    diverged,
                    jnp.logical_not(jnp.all(jnp.stack([
                        jnp.isfinite(jnp.asarray(v)) for e in err_list
                        for v in e
                    ]))),
                )

                if trace:
                    # aggregate primal/dual residual norms across constraints
                    lr = jnp.sqrt(sum(e[2] ** 2 for e in err_list))
                    ls = jnp.sqrt(sum(e[3] ** 2 for e in err_list))
                    history = history.at[it - state.it0, j, 0].set(
                        lr.astype(history.dtype))
                    history = history.at[it - state.it0, j, 1].set(
                        ls.astype(history.dtype))

                x[j] = xj
                z[j] = zj
                u[j] = uj
                steps_f_arr = steps_f_arr.at[j].set(steps_f_j)
                converged = converged.at[j].set(conv_j)

            return BSDMMState(
                x=tuple(x), z=tuple(z), u=tuple(u),
                steps_f=steps_f_arr, steps_g=tuple(steps_g_carry),
                steps_state=steps_state,
                it=it + 1, converged=converged, history=history,
                it0=state.it0, diverged=diverged,
            )

        return body, init_zu_l
    def init_state(xs, init_zu=init_zu, resume=None):
        xs = tuple(xs)
        if resume is None:
            z0, u0 = init_zu(xs)
            steps_f0 = jnp.ones((N,), dtype)
            steps_g0 = init_steps_g()
            ss0 = (steps_f_cb.init_bsdmm_state(xs)
                   if stateful_steps else ())
        else:
            # warm restart: per-block Z/U, carried steps, stepper
            # state AND the sweep clock continue (the stepper states
            # carry absolute next-refresh sweeps, so a restarted clock
            # would serve stale steps until it caught up — r4 review
            # sweep finding); max_iter still means "this many further
            # sweeps" via the it0-shifted bound. (The reference has no
            # ADMM-family resume; see admm._resume_state.)
            z0 = jax.tree_util.tree_map(jnp.asarray, tuple(resume["z"]))
            u0 = jax.tree_util.tree_map(jnp.asarray, tuple(resume["u"]))
            steps_f0 = jnp.asarray(resume["steps_f"], dtype)
            steps_g0 = jax.tree_util.tree_map(
                jnp.asarray, tuple(resume["steps_g"]))
            ss0 = jax.tree_util.tree_map(jnp.asarray,
                                         resume["steps_state"])
        it0 = (jnp.asarray(resume.get("it", 0), jnp.int32)
               if resume is not None else jnp.int32(0))
        conv0 = (jnp.asarray(resume.get("converged",
                                        np.zeros(N, bool)), bool)
                 if resume is not None else jnp.zeros((N,), bool))
        div0 = (jnp.asarray(resume.get("diverged", False), bool)
                if resume is not None else jnp.asarray(False))
        return BSDMMState(
            x=tuple(jnp.array(x, copy=True) for x in xs),
            z=z0, u=u0,
            steps_f=steps_f0,
            steps_g=steps_g0,
            steps_state=ss0,
            it=it0,
            converged=conv0,
            history=jnp.zeros((max_iter if trace else 0, N, 2), dtype),
            it0=it0,
            diverged=div0,
        )

    def cond(s):
        # it0-shifted bound: the sweep clock continues across warm
        # restarts (it0 == 0 fresh), so this one cond serves fresh,
        # resumed, export, and functional-factory paths alike
        return jnp.logical_and(
            s.it < s.it0 + max_iter,
            jnp.logical_and(jnp.logical_not(jnp.all(s.converged)),
                            jnp.logical_not(s.diverged)),
        )

    # segmented mode (opt-in stepper protocol): a stateful stepper with
    # strided/adaptive refresh exposes ``state_seg_end(state)`` — the
    # next iteration at which ANY block refreshes — and sets
    # ``segmented_bsdmm``. The loop then runs one refresh sweep (the
    # ordinary body: its per-block conds fire only for due blocks, so
    # the trajectory is IDENTICAL to the flat loop) followed by an
    # inner while of frozen-step sweeps that carries NO stepper state:
    # the warm-start power iterate and the refresh ``lax.cond`` stay
    # out of the hot loop (a cond over big carried state in a hot loop
    # breaks XLA's memory-space assignment and lands its cost on every
    # iteration — the r4 weighted-pgm regression).
    segmented = (stateful_steps
                 and getattr(steps_f_cb, "segmented_bsdmm", False)
                 and hasattr(steps_f_cb, "state_seg_end"))

    plain_strided = (not stateful_steps and steps_f_stride is not None
                     and steps_f_stride > 1)

    def make_loop(leaves):
        body, init_zu_l = make_body(leaves)
        if not (segmented or plain_strided):
            def loop(st):
                return jax.lax.while_loop(cond, body, st)

            return loop, init_zu_l
        fbody, _ = make_body(leaves, frozen=True)
        if segmented:
            _stepper_seg_end = steps_f_cb.state_seg_end

            def seg_end_fn(ss, it):
                return _stepper_seg_end(ss)
        else:
            # plain strided mode refreshes on `it % stride == 0`: the
            # segment ends at the next multiple >= the (post-sweep)
            # clock — ceil, not floor+1, so a resume sweep landing one
            # short of a boundary still refreshes ON the boundary
            def seg_end_fn(_, it):
                s = jnp.int32(steps_f_stride)
                return ((it + s - 1) // s) * s

        def loop(st):
            def outer_body(s):
                s = body(s)  # refresh sweep (due blocks only)
                seg_end = seg_end_fn(s.steps_state, s.it)
                ss = s.steps_state
                inner = s._replace(steps_state=())
                inner = jax.lax.while_loop(
                    lambda t: jnp.logical_and(cond(t), t.it < seg_end),
                    fbody, inner)
                return inner._replace(steps_state=ss)

            # resume mid-segment needs no pre-loop: the refresh sweep's
            # per-block conds self-gate on the carried next-refresh
            # clocks, so a not-yet-due sweep is exactly a frozen sweep
            return jax.lax.while_loop(cond, outer_body, st)

        return loop, init_zu_l

    return _BsdmmProgram(
        make_body=make_body, make_loop=make_loop, init_state=init_state,
        data_leaves=data_leaves, cond=cond,
        stateful_steps=stateful_steps,
    )


@utils.with_matmul_precision
def bsdmm(
    X,
    proxs_f,
    steps_f_cb,
    proxs_g=None,
    steps_g=None,
    Ls=None,
    update_order=None,
    steps_g_update="steps_f",
    max_iter=1000,
    e_rel=1e-6,
    e_abs=0,
    callback=None,
    trace=False,
    steps_f_stride=None,
    state=None,
    _export_runner=False,
):
    """Block-Simultaneous Method of Multipliers.

    Drop-in equivalent of the reference ``proxmin.bsdmm``
    (``algorithms.py:653-850``). ``proxs_f(X_j, step, Xs=None, j=None)``
    must be jit-traceable; ``steps_f_cb(Xs, j=None)`` computes the per-block
    step. ``steps_g_update`` in {'steps_f', 'fixed', 'relative'} selects
    how per-constraint steps track the block steps
    (reference ``algorithms.py:739-749``).

    ``steps_f_stride``: evaluate ``steps_f_cb`` only every this many
    sweeps, carrying the cached per-block step (shrunk by a 0.9 safety
    factor) in the solver state between refreshes — the bsdmm analogue
    of pgm's :class:`~proxmin_tpu.utils.StridedStepper` for expensive
    (e.g. weighted-Lipschitz) step callables. Only the taken
    ``lax.cond`` branch executes, so skipped sweeps pay nothing.

    ``state``: warm-restart state from a previous solve's ``.state``
    attribute (checkpointable): per-block Z/U, carried step values and
    stepper state continue where the previous solve stopped; pass the
    previous solve's ``X`` blocks. A resumed solve runs up to
    ``max_iter`` further sweeps.

    Returns:
        ``SolverResult`` unpacking as the per-block converged tuple (the
        reference returns that list) with attributes ``.x``,
        ``.iterations``, ``.converged``, ``.state`` (warm-restart
        pytree).
    """
    x0, originals, _ = tupleize(X)
    N = len(x0)

    # the refresh phase of strided steps lives partly in static config
    # (`it % steps_f_stride`, a stateful stepper's stride/adapt), so a
    # resume under a different stride silently refreshes on the wrong
    # schedule — reject the mismatch instead (r4 review finding)
    stride_cfg = (0 if steps_f_stride is None else int(steps_f_stride),
                  int(getattr(steps_f_cb, "stride", 0) or 0),
                  bool(getattr(steps_f_cb, "adapt", False)))
    if state is not None and "stride_config" in state:
        st_cfg = tuple(state["stride_config"])
        st_cfg = (int(st_cfg[0]), int(st_cfg[1]), bool(st_cfg[2]))
        if st_cfg != stride_cfg:
            raise ValueError(
                "state= was produced under a different step-stride "
                "configuration ((steps_f_stride, stepper stride, "
                "adapt) = {} vs this call's {}); resume with the same "
                "settings".format(st_cfg, stride_cfg)
            )

    # capture user-level argument identities BEFORE normalization wraps
    # them (the driver cache must key on stable user objects)
    _user_structs = (proxs_g, steps_g, Ls)

    # normalized copies for the cache key (the builder re-normalizes
    # idempotently)
    if update_order is not None:
        update_order = tuple(int(j) for j in update_order)
    e_rel = [e_rel] * N if np.isscalar(e_rel) else list(e_rel)
    e_abs = [e_abs] * N if np.isscalar(e_abs) else list(e_abs)
    dtype = jnp.result_type(*[x.dtype for x in x0])

    prog = _build_bsdmm(
        N, dtype, proxs_f, steps_f_cb, proxs_g, steps_g, Ls,
        update_order, steps_g_update, e_rel, e_abs, max_iter,
        steps_f_stride, trace,
    )
    make_body = prog.make_body
    init_state = prog.init_state
    data_leaves = prog.data_leaves

    if _export_runner:
        # AOT-export path (export.py): pure ``*x_blocks -> final state``
        # with the data leaves baked as trace constants
        loop, _ = prog.make_loop(data_leaves)

        def runner(*x_blocks):
            return loop(init_state(x_blocks))

        return runner

    steps_key = (steps_f_cb.stepper_cache_key()
                 if hasattr(steps_f_cb, "stepper_cache_key")
                 else callable_key(steps_f_cb))
    cache_key = (
        "bsdmm", callable_key(proxs_f), steps_key,
        nested_key(_user_structs),
        update_order, steps_g_update, steps_f_stride,
        tuple(float(v) for v in e_rel), tuple(float(v) for v in e_abs),
        max_iter, trace, callback is None, abstract_key(x0),
    )

    def build():
        if callback is None:
            # initial state built INSIDE the executable (eager
            # construction dispatches several host->device ops per
            # solve; see the pgm driver)
            def run(x, leaves, resume):
                loop, init_zu_l = prog.make_loop(leaves)
                state = init_state(x, init_zu=init_zu_l, resume=resume)
                return loop(state)

            # not donated, like the pgm driver
            compiled = jax.jit(run)
        else:
            compiled = jax.jit(lambda s, leaves: make_body(leaves)[0](s))
        # retain the key's id-referenced objects alive with the entry
        return compiled, (proxs_f, steps_f_cb, _user_structs)

    if cacheable(cache_key):
        compiled, _ = _BSDMM_CACHE.get_or_build(cache_key, build)
    else:
        # mutable NumPy data in the key: bypass (retrace per call)
        compiled, _ = build()

    resume = state
    if callback is None:
        state = compiled(tuple(x0), data_leaves, resume)
    else:
        state = init_state(x0, resume=resume)
        while bool(prog.cond(state)):
            try:
                callback(*[np.asarray(xj) for xj in state.x], it=int(state.it))
            except StopIteration:
                break
            state = compiled(state, data_leaves)

    # one batched device->host fetch (each round trip costs a sync)
    it_h, it0_h, conv_h, div_h = jax.device_get(
        (state.it, state.it0, state.converged, state.diverged))
    iterations = int(it_h) - int(it0_h)
    logger.info("Completed %d iterations", iterations)
    converged = tuple(bool(c) for c in conv_h)
    diverged = bool(div_h)
    status = status_from(all(converged), diverged, logger)

    writeback(originals, state.x)
    history = np.asarray(state.history[:iterations]) if trace else None
    return SolverResult(
        converged,
        x=state.x, iterations=iterations, converged=converged,
        history=history, status=status,
        state={"z": state.z, "u": state.u, "steps_f": state.steps_f,
               "steps_g": state.steps_g,
               "steps_state": state.steps_state, "it": state.it,
               "stride_config": stride_cfg,
               # terminal flags: a stopped solve stays stopped on
               # resume (see pgm's resume_state note)
               "converged": state.converged,
               "diverged": state.diverged},
    )
