"""Pure-functional solver factories: jittable, vmap-able solves.

The top-level drivers (:func:`proxmin_tpu.pgm`, ...) are host APIs — they
match the reference's calling convention (NumPy write-back, callbacks,
logging, driver caching). This module exposes the same compiled cores as
*pure functions* for composition with JAX transforms:

* ``jax.vmap(solve)`` solves a whole **batch of problems in one compiled
  call** — under ``vmap`` the ``lax.while_loop`` runs until every lane
  converges (converged lanes hold their fixed point, so results equal the
  per-problem solves). The reference (one Python loop per solve,
  ``proxmin/algorithms.py``) has no analogue; on an accelerator this
  turns thousands of small independent solves into one device program.
* ``jax.jit`` / ``lax.map`` / checkpointing compose the same way.

``make_pgm_solver`` and ``make_adaprox_solver`` reuse the drivers' own
body/init/cond builders (the same ones the AOT exporter serializes), so
they cannot drift from the in-process semantics.
``make_differentiable_pgm_solver`` is a separate, deliberately minimal
forward-backward iteration (global fixed-point test, static scalar
step) — the price of a clean implicit-differentiation structure.

Reverse-mode differentiation *through* a ``lax.while_loop`` is not
defined; :func:`make_differentiable_pgm_solver` instead differentiates
*at the solution* via the implicit function theorem (no unrolling, O(1)
memory in the iteration count) — solutions become nodes in a larger
differentiable program (hyperparameter gradients, bilevel problems).
"""

import jax
import jax.numpy as jnp

from .utils import with_matmul_precision
from .precision import STREAM_PRECISION, TINY_PRECISION

from . import utils
from .utils import make_stepper

__all__ = ["make_pgm_solver", "make_adaprox_solver",
           "make_admm_solver", "make_sdmm_solver", "make_bsdmm_solver",
           "make_differentiable_pgm_solver",
           "make_differentiable_adaprox_solver",
           "make_differentiable_admm_solver",
           "make_differentiable_sdmm_solver",
           "make_differentiable_bsdmm_solver", "make_nmf_solver"]


def make_pgm_solver(grad, step, prox=None, accelerated=False,
                    restart=False, backtracking=False, f=None,
                    e_rel=1e-6, max_iter=1000):
    """Build a pure PGM/FISTA solve: ``solve(*x0) -> (x, iterations,
    converged, diverged)``.

    Same semantics as :func:`proxmin_tpu.pgm` (reference
    ``algorithms.py:12-144``) minus the host conveniences. The returned
    callable is pure and traceable: wrap in ``jax.jit`` yourself, or
    ``jax.vmap`` it over a leading batch axis of the initial blocks.
    ``grad=None`` derives the gradient from ``f`` via ``jax.grad``.
    """
    from .solvers.common import grad_from_f, normalize_per_block, \
        normalize_prox
    from .solvers.pgm import _init_state, _make_pgm_body, _run_fused

    def solve(*x0):
        n = len(x0)
        g = grad if grad is not None else grad_from_f(f, n)
        prox_t = normalize_prox(prox, n)
        e_rel_t = normalize_per_block(e_rel, n)
        assert backtracking is False or f is not None
        stepper = make_stepper(step, n)
        body = _make_pgm_body(g, stepper, prox_t, e_rel_t, accelerated,
                              backtracking, f, restart=restart)
        state = _init_state(x0, g, stepper, n, max_iter, False, accelerated)
        st = _run_fused(state, body, max_iter, n)
        x = st.x[0] if n == 1 else st.x
        return x, st.it, st.converged, st.diverged

    return with_matmul_precision(solve)


def make_adaprox_solver(grad, step, prox=None, scheme="adam", b1=0.9,
                        b2=0.999, eps=1e-8, p=0.25, check_convergence=True,
                        e_rel=1e-6, max_iter=1000, prox_max_iter=1000,
                        f=None, separable_prox=False, moment_dtype=None):
    """Build a pure AdaProx solve: ``solve(*x0) -> (x, M, V, Vhat,
    iterations, converged, diverged)`` (cold-started moments).

    Same semantics as :func:`proxmin_tpu.adaprox` (reference
    ``algorithms.py:248-423``); jit/vmap-compatible like
    :func:`make_pgm_solver`.
    """
    from .solvers.adaprox import (
        SCHEMES, _make_adaprox_body, init_adaprox_state, make_adaprox_cond,
        normalize_b1_schedule,
    )
    from .solvers.common import (
        grad_from_f, normalize_per_block, normalize_prox, separable_blocks,
    )

    b1 = normalize_b1_schedule(b1, max_iter)
    assert 0 <= b2 < 1
    assert eps >= 0
    assert 0 < p <= 0.5
    phi_psi = SCHEMES[scheme.lower()]

    def solve(*x0):
        n = len(x0)
        g = grad if grad is not None else grad_from_f(f, n)
        prox_in = utils._as_tuple(prox)
        if len(prox_in) == 1:
            prox_in = prox_in * n
        has_prox = tuple(pj is not None for pj in prox_in)
        prox_t = normalize_prox(prox_in, n)
        e_rel_t = normalize_per_block(e_rel, n)
        separable = separable_blocks(prox_in, has_prox, separable_prox)
        stepper = make_stepper(step, n)
        body = _make_adaprox_body(g, stepper, prox_t, has_prox, phi_psi,
                                  b1, b2, eps, p, e_rel_t,
                                  check_convergence, prox_max_iter,
                                  separable=separable,
                                  moment_dtype=moment_dtype)
        zeros = tuple(jnp.zeros(x.shape, moment_dtype or x.dtype)
                      for x in x0)
        state = init_adaprox_state(x0, zeros, zeros, zeros, stepper, g,
                                   n, max_iter, trace=False)
        cond = make_adaprox_cond(check_convergence, max_iter)
        st = jax.lax.while_loop(cond, body, state)
        x = st.x[0] if n == 1 else st.x
        return x, st.M, st.V, st.Vhat, st.it, st.converged, st.diverged

    return with_matmul_precision(solve)


def make_admm_solver(prox_f, step_f, prox_g=None, step_g=None, L=None,
                     e_rel=1e-6, e_abs=0, max_iter=1000, adapt_step=False):
    """Build a pure linearized-ADMM solve: ``solve(x0) -> (x, iterations,
    converged, errors)`` (``errors`` = the Boyd §3.3.1 residual rows,
    shape ``(1, 4)``).

    Same semantics as :func:`proxmin_tpu.admm` (reference
    ``algorithms.py:426-520``), including the slack-restart heuristic,
    minus the host conveniences — jit/vmap-compatible like
    :func:`make_pgm_solver`, so ``jax.vmap(solve)`` runs a batch of
    independent ADMM problems in one compiled call (under ``vmap`` the
    ``lax.while_loop`` freezes finished lanes, so per-lane results equal
    the individual solves). All callables must be jit-traceable.
    """
    from .linop import as_linear_operator
    from .solvers.admm import _sdmm_core

    if prox_g is None and L is not None:
        raise ValueError(
            "L is only applied inside the g-constraint (g(L x)); with "
            "prox_g=None the solve is unconstrained and L would be "
            "silently ignored — pass prox_g or drop L"
        )
    Lop = as_linear_operator(L)
    proxs_g = (prox_g,) if prox_g is not None else ()
    steps_g = (step_g,) if prox_g is not None else ()
    runner = _sdmm_core(
        None, prox_f, step_f, proxs_g, steps_g,
        (Lop,) if prox_g is not None else (),
        e_rel, e_abs, max_iter, None, return_errors=True,
        return_runner=True, adapt_step=adapt_step,
    )

    def solve(x0):
        st = runner(x0)
        return st.x, st.it, st.converged, st.errors

    return with_matmul_precision(solve)


def make_sdmm_solver(prox_f, step_f, proxs_g, steps_g=None, Ls=None,
                     e_rel=1e-6, e_abs=0, max_iter=1000, adapt_step=False):
    """Build a pure SDMM solve (M simultaneous constraints):
    ``solve(x0) -> (x, iterations, converged, errors)`` (``errors``
    shape ``(M, 4)``).

    Same semantics as :func:`proxmin_tpu.sdmm` (reference
    ``algorithms.py:523-650``); jit/vmap-compatible like
    :func:`make_pgm_solver`.
    """
    from .linop import as_linear_operator
    from .solvers.admm import _sdmm_core

    proxs_g = tuple(proxs_g)
    M = len(proxs_g)
    if not hasattr(Ls, "__iter__"):
        Ls = [Ls] * M
    Lops = tuple(as_linear_operator(Li) for Li in Ls)
    steps_g = (None,) * M if steps_g is None else tuple(steps_g)
    assert len(steps_g) == M
    runner = _sdmm_core(
        None, prox_f, step_f, proxs_g, steps_g, Lops,
        e_rel, e_abs, max_iter, None, return_errors=False,
        admm_convention=False, return_runner=True, adapt_step=adapt_step,
    )

    def solve(x0):
        st = runner(x0)
        return st.x, st.it, st.converged, st.errors

    return with_matmul_precision(solve)


def make_bsdmm_solver(proxs_f, steps_f_cb, proxs_g=None, steps_g=None,
                      Ls=None, update_order=None, steps_g_update="steps_f",
                      e_rel=1e-6, e_abs=0, max_iter=1000,
                      steps_f_stride=None):
    """Build a pure bSDMM solve: ``solve(*x_blocks) -> (x_blocks,
    iterations, converged_per_block)``.

    Same semantics as :func:`proxmin_tpu.bsdmm` (reference
    ``algorithms.py:653-850``); jit/vmap-compatible like
    :func:`make_pgm_solver`. The solver structure (block count, dtype,
    constraint topology) is resolved from the actual blocks at trace
    time, so one factory output works across shapes/dtypes (one compile
    each, the standard jit contract). Built on the driver's own
    ``_build_bsdmm`` body/init builders — same program as the host
    driver, with the built pieces memoized per (block count, dtype) so
    repeated traces pay no reconstruction.
    """
    from .solvers.bsdmm import _build_bsdmm

    programs = {}

    def solve(*x_blocks):
        dtype = jnp.result_type(*[x.dtype for x in x_blocks])
        key = (len(x_blocks), jnp.dtype(dtype).name)
        prog = programs.get(key)
        if prog is None:
            prog = programs[key] = _build_bsdmm(
                len(x_blocks), dtype, proxs_f, steps_f_cb,
                proxs_g=proxs_g, steps_g=steps_g, Ls=Ls,
                update_order=update_order,
                steps_g_update=steps_g_update, e_rel=e_rel, e_abs=e_abs,
                max_iter=max_iter, steps_f_stride=steps_f_stride,
            )
        loop, init_zu = prog.make_loop(prog.data_leaves)
        st = loop(prog.init_state(x_blocks, init_zu=init_zu))
        return st.x, st.it, st.converged

    return with_matmul_precision(solve)


def make_differentiable_pgm_solver(grad, step, prox=None, e_rel=1e-9,
                                   max_iter=1000, vjp_iters=10000,
                                   vjp_rtol=1e-9, prox_params=False):
    """Build a PGM solve differentiable w.r.t. problem parameters via
    implicit differentiation at the fixed point.

    ``grad(x, *theta)`` is the smooth-part gradient parameterized by the
    differentiable inputs ``theta`` (arrays/pytrees); ``step`` is a
    static scalar (< 2/L); ``prox(z, step)`` an optional constraint.
    ``x`` may be any pytree (e.g. the two-block ``(A, S)`` of NMF —
    ``grad`` returns the matching structure and ``prox`` handles blocks
    internally). Returns ``solve(x0, *theta) -> (x*, converged)`` usable
    inside ``jax.grad`` / ``jax.jit`` / ``jax.vmap`` (the bool carries
    no gradient). ALWAYS check ``converged``: if the forward pass
    stopped at ``max_iter`` short of the fixed point, the backward pass
    differentiates at a non-fixed point and the result (including the
    zero gradient w.r.t. ``x0``) is not meaningful.

    The forward pass runs plain forward-backward iterations
    ``x <- T(x, theta) = prox(x - step * grad(x, theta), step)`` to the
    fixed-point tolerance. The backward pass applies the implicit
    function theorem at the solution: with ``A = d_x T`` and
    ``B = d_theta T``, ``dx* = (I - A)^{-1} B dtheta``, so the VJP
    solves ``w = A^T w + v`` by fixed-point iteration — run to a
    relative residual of ``vjp_rtol`` (capped at ``vjp_iters``; the
    iteration count adapts to the problem's conditioning, ~1/(step*mu)
    steps for strong-convexity constant mu) — and returns ``B^T w``.
    O(1) memory in the iteration count, no unrolling, independent of
    the forward pass's path.

    Convergence of the adjoint (and local uniqueness of the solution)
    requires ``spectral_radius(d_x T) < 1`` at the fixed point — e.g.
    LOCAL STRONG CONVEXITY, not merely ``step < 2/L``: for a singular
    Hessian the implicit system ``(I - d_x T)`` is singular and the
    solution map has no derivative. Bilinear factorizations (NMF-type)
    generally do NOT qualify — their joint Hessian is singular at
    generic minima even with a ridge (gauge-like flat directions), so
    neither this VJP nor finite differences is well-defined for them.
    For nonsmooth proxs (e.g. projections) the map is differentiable
    almost everywhere; at active-set boundaries the returned gradient
    is the one induced by JAX's subgradient conventions for the prox.

    With ``prox_params=True`` the prox is called as
    ``prox(z, step, *theta)`` so the same differentiable parameters can
    drive the constraint/regularizer (e.g. learning a soft-threshold
    strength); gradients flow through both the gradient and the prox.
    """
    def T(x, *theta):
        z = jax.tree_util.tree_map(lambda xi, gi: xi - step * gi, x,
                                   grad(x, *theta))
        if prox is None:
            return z
        return prox(z, step, *theta) if prox_params else prox(z, step)

    return _implicit_fixed_point_solver(T, e_rel, max_iter, vjp_iters,
                                        vjp_rtol)


def _implicit_fixed_point_solver(T, e_rel, max_iter, vjp_iters, vjp_rtol,
                                 forward=None):
    """The shared IFT scaffolding: a custom-vjp ``solve(w0, *theta) ->
    (w*, converged)`` for an arbitrary (locally contractive) iteration
    map ``T(w, *theta)`` over a pytree state ``w``. Forward: plain
    fixed-point iteration to the relative tolerance — or an arbitrary
    ``forward(w0, *theta) -> (w*, converged)`` override whose solution
    satisfies ``T(w*) = w*`` (e.g. an accelerated or adaptive solver
    for the same problem; the backward pass only ever sees ``T`` at the
    solution, so the forward trajectory is free). Backward: the
    adjoint fixed point ``v = (d_w T)^T v + cotangent`` run to
    ``vjp_rtol``, then pushed through ``d_theta T`` — O(1) memory in
    the iteration count, no unrolling. See
    :func:`make_differentiable_pgm_solver` for the convergence caveats
    (``spectral_radius(d_w T) < 1`` required; the ``w0`` cotangent is
    identically zero by construction)."""
    tree = jax.tree_util

    def tree_l2sq(t):
        return sum(jnp.sum(l * l) for l in tree.tree_leaves(t))

    def tree_sub(a, b):
        return tree.tree_map(lambda x, y: x - y, a, b)

    @jax.custom_vjp
    def solve(x0, *theta):
        if forward is not None:
            return forward(x0, *theta)

        def cond(c):
            x, x_prev, it = c
            return jnp.logical_and(
                it < max_iter,
                tree_l2sq(tree_sub(x, x_prev)) > (e_rel ** 2) * tree_l2sq(x),
            )

        def body(c):
            x, _, it = c
            return T(x, *theta), x, it + 1

        x, x_prev, _ = jax.lax.while_loop(
            cond, body, (T(x0, *theta), x0, jnp.int32(1))
        )
        converged = tree_l2sq(tree_sub(x, x_prev)) \
            <= (e_rel ** 2) * tree_l2sq(x)
        return x, converged

    def fwd(x0, *theta):
        out = solve(x0, *theta)
        return out, (out[0], theta)

    def bwd(res, v):
        x, theta = res
        v_x = v[0]  # v[1] is the bool output's zero cotangent
        _, vjp_T = jax.vjp(T, x, *theta)

        def step_w(w):
            return tree.tree_map(jnp.add, vjp_T(w)[0], v_x)

        # adjoint fixed point w = A^T w + v, run to a RELATIVE RESIDUAL
        # (a fixed iteration count silently truncates the Neumann series
        # on ill-conditioned problems: at contraction factor q the error
        # is q^k — 40% gradient error measured at condition number 100
        # with a fixed k=100)
        def cond(c):
            w, w_prev, it = c
            return jnp.logical_and(
                it < vjp_iters,
                tree_l2sq(tree_sub(w, w_prev))
                > (vjp_rtol ** 2) * tree_l2sq(w),
            )

        def body(c):
            w, _, it = c
            return step_w(w), w, it + 1

        w, _, _ = jax.lax.while_loop(
            cond, body, (step_w(v_x), v_x, jnp.int32(1))
        )
        outs = vjp_T(w)
        return (tree.tree_map(jnp.zeros_like, x),) + tuple(outs[1:])

    solve.defvjp(fwd, bwd)
    return with_matmul_precision(solve)


def make_differentiable_adaprox_solver(grad, step, prox=None, b1=0.9,
                                       b2=0.999, eps=1e-8, e_rel=1e-9,
                                       max_iter=1000, vjp_iters=10000,
                                       vjp_rtol=1e-9, prox_params=False):
    """Build a proximal-Adam (AdaProx, ``scheme='adam'``) solve
    differentiable w.r.t. problem parameters — completing the
    differentiable surface across all five solver families (the
    reference treats them uniformly, ``algorithms.py:248-423``).

    Forward pass: bias-corrected proximal-Adam iterations
    ``x <- prox(x - step * Phi/Psi, step/Psi)`` run to the fixed-point
    tolerance (the separable closed-form scaled prox — the prox must
    accept elementwise step arrays, true of every separable operator in
    :mod:`proxmin_tpu.operators`). Backward pass: implicit
    differentiation of the PGM optimality condition
    ``x = prox(x - step * grad(x))`` at the solution. This is valid
    because Adam's ``1/Psi`` preconditioner is a positive diagonal
    metric: for any such metric the scaled proximal fixed points are
    exactly the stationary points of ``f + g``, i.e. the SAME solution
    set as the unscaled PGM map — so the (smooth, contractive near a
    strongly-convex solution) PGM map is the right characterization to
    differentiate, regardless of the trajectory Adam took to get there.
    ``step`` must therefore satisfy the usual backward-pass contraction
    requirement (static scalar < 2/L) even though the forward pass is
    adaptive.

    Returns ``solve(x0, *theta) -> (x*, converged)`` usable inside
    ``jax.grad`` / ``jax.jit`` / ``jax.vmap``. ALWAYS check
    ``converged`` — Adam can stall in an oscillatory limit cycle short
    of the tolerance, and the backward pass is only meaningful at a
    fixed point. All spectral-radius / strong-convexity caveats of
    :func:`make_differentiable_pgm_solver` apply verbatim.
    """
    tree = jax.tree_util

    def tree_l2sq(t):
        return sum(jnp.sum(l * l) for l in tree.tree_leaves(t))

    def tree_sub(a, b):
        return tree.tree_map(lambda x, y: x - y, a, b)

    def _prox(z, s, *theta):
        if prox is None:
            return z
        return prox(z, s, *theta) if prox_params else prox(z, s)

    def T(x, *theta):
        z = tree.tree_map(lambda xi, gi: xi - step * gi, x,
                          grad(x, *theta))
        return _prox(z, step, *theta)

    def forward(x0, *theta):
        zeros = tree.tree_map(jnp.zeros_like, x0)

        def body(c):
            x, _, m, v, it = c
            g = grad(x, *theta)
            t = (it + 1).astype(jnp.float32)
            m1 = tree.tree_map(
                lambda mi, gi: b1 * mi + (1.0 - b1) * gi, m, g)
            v1 = tree.tree_map(
                lambda vi, gi: b2 * vi + (1.0 - b2) * gi * gi, v, g)
            bc1 = 1.0 - b1 ** t
            bc2 = 1.0 - b2 ** t
            psi = tree.tree_map(
                lambda vi: jnp.sqrt(vi / bc2) + eps, v1)
            z = tree.tree_map(
                lambda xi, mi, pi: xi - step * (mi / bc1) / pi,
                x, m1, psi)
            s_arr = tree.tree_map(lambda pi: step / pi, psi)
            x1 = _prox(z, s_arr, *theta)
            return x1, x, m1, v1, it + 1

        def cond(c):
            x, x_prev, _, _, it = c
            return jnp.logical_and(
                it < max_iter,
                tree_l2sq(tree_sub(x, x_prev))
                > (e_rel ** 2) * tree_l2sq(x),
            )

        c0 = body((x0, x0, zeros, zeros, jnp.int32(0)))
        x, x_prev, _, _, _ = jax.lax.while_loop(cond, body, c0)
        converged = tree_l2sq(tree_sub(x, x_prev)) \
            <= (e_rel ** 2) * tree_l2sq(x)
        return x, converged

    return _implicit_fixed_point_solver(T, e_rel, max_iter, vjp_iters,
                                        vjp_rtol, forward=forward)


def make_differentiable_admm_solver(prox_f, step_f, prox_g, step_g=None,
                                    L=None, e_rel=1e-9, max_iter=1000,
                                    vjp_iters=10000, vjp_rtol=1e-9,
                                    prox_params=False):
    """Build a linearized-ADMM solve differentiable w.r.t. problem
    parameters via implicit differentiation at the fixed point — the
    ADMM-family sibling of :func:`make_differentiable_pgm_solver`.

    The iteration map is one fixed-step ADMM update over the full state
    ``w = (x, z, u)`` (:func:`utils.update_variables`: the linearized
    x-update then the z/u multiplier step; no slack restart, no
    residual balancing — those are non-smooth control flow). With
    ``prox_params=True`` both proxs are called as
    ``prox(v, step, *theta)``, so the differentiable parameters can
    drive the data term AND the regularizer (e.g. learning a TV
    strength through ``prox_g``). Returns
    ``solve(x0, *theta) -> (x*, converged)`` usable inside
    ``jax.grad`` / ``jax.jit`` / ``jax.vmap``.

    Caveats mirror the PGM version: the adjoint converges iff
    ``spectral_radius(d_w T) < 1`` at the fixed point — guaranteed when
    ``f`` is locally strongly convex around the solution and the proxs
    are differentiable there (the ADMM map is averaged/nonexpansive in
    general, with radius exactly 1 along flat directions — there the
    solution map has no derivative and neither this VJP nor finite
    differences is defined). At nonsmooth points of the proxs
    (active-set boundaries) the returned gradient follows JAX's
    subgradient conventions. ALWAYS check ``converged``; the ``x0``
    cotangent is identically zero (the fixed point does not depend on
    the start).
    """
    from .linop import as_linear_operator
    from . import utils as _utils

    Lop = as_linear_operator(L)
    sg = (step_g if step_g is not None
          else _utils.get_step_g(step_f, Lop.spectral_norm_sq))

    def T(w, *theta):
        x, z, u = w
        if prox_params:
            pf = lambda v, s: prox_f(v, s, *theta)   # noqa: E731
            pg = lambda v, s: prox_g(v, s, *theta)   # noqa: E731
        else:
            pf, pg = prox_f, prox_g
        x, z, u, _, _, _ = _utils.update_variables(
            x, z, u, pf, step_f, pg, sg, Lop
        )
        return (x, z, u)

    inner = _implicit_fixed_point_solver(T, e_rel, max_iter, vjp_iters,
                                         vjp_rtol)

    def solve(x0, *theta):
        z0, u0 = _utils.initZU(x0, Lop)
        w, converged = inner((x0, z0, u0), *theta)
        return w[0], converged

    return with_matmul_precision(solve)


def make_differentiable_sdmm_solver(prox_f, step_f, proxs_g, steps_g=None,
                                    Ls=None, e_rel=1e-9, max_iter=1000,
                                    vjp_iters=10000, vjp_rtol=1e-9,
                                    prox_params=False):
    """Differentiable SDMM (M simultaneous constraints) via implicit
    differentiation at the fixed point — extends
    :func:`make_differentiable_admm_solver` to constraint lists, so the
    whole solver family is uniformly differentiable (the reference
    treats all five solvers uniformly,
    ``proxmin/algorithms.py:426-850``).

    The iteration map is one fixed-step SDMM update over
    ``w = (x, Z_1..M, U_1..M)`` (:func:`utils.update_variables`'s
    multi-constraint branch; no slack restart — non-smooth control
    flow). ``steps_g[i]`` default to the ``step_f * ||L_i||^2 * M``
    coupling. With ``prox_params=True`` every prox (f and each g_i) is
    called as ``prox(v, step, *theta)``. Returns
    ``solve(x0, *theta) -> (x*, converged)``; the convergence caveats of
    :func:`make_differentiable_admm_solver` apply verbatim (spectral
    radius of the update map < 1 at the solution; ALWAYS check
    ``converged``).
    """
    from .linop import as_linear_operator
    from . import utils as _utils

    proxs_g = tuple(proxs_g)
    M = len(proxs_g)
    if not hasattr(Ls, "__iter__"):
        Ls = [Ls] * M
    Lops = tuple(as_linear_operator(Li) for Li in Ls)
    if steps_g is None:
        steps_g = tuple(
            _utils.get_step_g(step_f, Lops[i].spectral_norm_sq, M=M)
            for i in range(M)
        )
    steps_g = tuple(steps_g)
    assert len(steps_g) == M

    def T(w, *theta):
        x, z, u = w
        if prox_params:
            pf = lambda v, s: prox_f(v, s, *theta)          # noqa: E731
            pgs = [
                (lambda v, s, _p=p: _p(v, s, *theta)) for p in proxs_g
            ]
        else:
            pf, pgs = prox_f, list(proxs_g)
        x, z, u, _, _, _ = _utils.update_variables(
            x, list(z), list(u), pf, step_f, pgs, list(steps_g),
            list(Lops),
        )
        return (x, tuple(z), tuple(u))

    inner = _implicit_fixed_point_solver(T, e_rel, max_iter, vjp_iters,
                                         vjp_rtol)

    def solve(x0, *theta):
        z0, u0 = _utils.initZU(x0, list(Lops))
        w, converged = inner((x0, tuple(z0), tuple(u0)), *theta)
        return w[0], converged

    return with_matmul_precision(solve)


def make_differentiable_bsdmm_solver(proxs_f, steps_f, proxs_g=None,
                                     steps_g=None, Ls=None,
                                     update_order=None, e_rel=1e-9,
                                     max_iter=1000, vjp_iters=10000,
                                     vjp_rtol=1e-9, prox_params=False):
    """Differentiable block-SDMM via implicit differentiation at the
    fixed point — completes solver-family uniformity for the
    differentiable surface (reference treats all five solvers uniformly,
    ``proxmin/algorithms.py:426-850``).

    The iteration map is one Gauss–Seidel sweep over the N blocks (each
    block's ``proxs_f`` sees the already-updated earlier blocks, like
    the host driver), with FIXED per-block steps: ``steps_f`` is a
    list of N static scalars (the differentiable surface trades the
    driver's adaptive step machinery for a clean implicit structure,
    exactly like ``make_differentiable_pgm_solver``'s static step).
    ``proxs_g[j]`` is an optional list of M_j constraint proxs with
    ``Ls[j]`` operators; ``steps_g[j][i]`` default to the
    ``steps_f[j] * ||L_ji||^2 * N * M_j`` coupling.

    ``proxs_f(v, step, *theta, Xs=..., j=...)`` is the block data-term
    prox (gradient-step closures work: theta can carry Y); with
    ``prox_params=True`` the constraint proxs are also called as
    ``prox(v, step, *theta)``. Returns
    ``solve(x_blocks_tuple, *theta) -> (x_blocks, converged)``.
    Convergence caveats as in :func:`make_differentiable_admm_solver`;
    note that bilinear CMF objectives are generically NOT locally
    strongly convex jointly (gauge freedom), so per-block theta
    gradients are meaningful only where the fixed point is locally
    unique.
    """
    from .linop import as_linear_operator
    from . import utils as _utils

    def solve(x0, *theta):
        N = len(x0)
        steps = list(steps_f) if hasattr(steps_f, "__iter__") \
            else [steps_f] * N
        assert len(steps) == N
        pg = list(proxs_g) if proxs_g is not None else [None] * N
        assert len(pg) == N
        Ls_n = list(Ls) if hasattr(Ls, "__iter__") else [Ls] * N
        sg_n = list(steps_g) if steps_g is not None else [None] * N
        order = tuple(update_order) if update_order is not None \
            else tuple(range(N))

        M = [0] * N
        Lops = [None] * N
        sgs = [None] * N
        for j in range(N):
            if pg[j] is not None:
                pj = pg[j] if hasattr(pg[j], "__iter__") else [pg[j]]
                pg[j] = tuple(pj)
                M[j] = len(pg[j])
                Lj = Ls_n[j] if hasattr(Ls_n[j], "__iter__") \
                    else [Ls_n[j]] * M[j]
                Lops[j] = tuple(as_linear_operator(Li) for Li in Lj)
                if sg_n[j] is None:
                    sgs[j] = tuple(
                        _utils.get_step_g(
                            steps[j], Lops[j][i].spectral_norm_sq,
                            N=N, M=M[j])
                        for i in range(M[j])
                    )
                else:
                    sgs[j] = tuple(sg_n[j])
            else:
                Lops[j] = as_linear_operator(None)

        def T(w, *theta):
            xs, zs, us = list(w[0]), list(w[1]), list(w[2])
            for j in order:
                xs_now = tuple(xs)

                def pf_j(v, s, _j=j, _xs=xs_now):
                    return proxs_f(v, s, *theta, Xs=_xs, j=_j)

                if M[j] > 0:
                    if prox_params:
                        pgs_j = [
                            (lambda v, s, _p=p: _p(v, s, *theta))
                            for p in pg[j]
                        ]
                    else:
                        pgs_j = list(pg[j])
                    xj, zj, uj, _, _, _ = _utils.update_variables(
                        xs[j], list(zs[j]), list(us[j]), pf_j, steps[j],
                        pgs_j, list(sgs[j]), list(Lops[j]),
                    )
                    zs[j], us[j] = tuple(zj), tuple(uj)
                else:
                    xj, zj, uj, _, _, _ = _utils.update_variables(
                        xs[j], zs[j], us[j], pf_j, steps[j], None, None,
                        Lops[j],
                    )
                    zs[j], us[j] = zj, uj
                xs[j] = xj
            return (tuple(xs), tuple(zs), tuple(us))

        inner = _implicit_fixed_point_solver(T, e_rel, max_iter,
                                             vjp_iters, vjp_rtol)

        z0, u0 = [], []
        for j in range(N):
            if M[j] > 0:
                zj, uj = _utils.initZU(x0[j], list(Lops[j]))
                z0.append(tuple(zj))
                u0.append(tuple(uj))
            else:
                z0.append(x0[j])
                u0.append(jnp.zeros_like(x0[j]))
        w, converged = inner((tuple(x0), tuple(z0), tuple(u0)), *theta)
        return w[0], converged

    return with_matmul_precision(solve)


def make_nmf_solver(prox_A=None, prox_S=None, e_rel=1e-3, max_iter=1000,
                    weighted=False, cold_iters=32, warm_iters=8,
                    safety=0.9):
    """Build a pure PGM-NMF solve with the DATA as an argument:
    ``solve(A0, S0, Y) -> (A, S, iterations, converged)`` — or, with
    ``weighted=True``, ``solve(A0, S0, Y, W)``.

    Unlike :func:`proxmin_tpu.nmf.nmf` (a host driver that binds Y
    internally), the returned callable is pure with ``Y`` (and ``W``)
    as inputs — so ``jax.vmap(solve)`` factorizes a whole BATCH of
    problems (e.g. per-patch unmixing of an image grid) in one compiled
    call, each lane running the reference-math PGM-NMF iteration
    (gradients, on-device Lipschitz steps, non-negativity by default)
    until its own fixed-point tolerance.

    The weighted Lipschitz bounds use only matvec/elementwise power
    iterations (vmap-safe; a vmapped ``eigvalsh`` is a poor fit for the
    batch): the C channel Grams by ``cold_iters`` passes, the
    per-pixel bound by the implicit batched power iteration with its
    iterate warm-started ACROSS solver iterations in the loop carry
    (``cold_iters`` passes on the first iteration, ``warm_iters``
    after), shrunk by ``safety`` to guard the warm estimate — the same
    machinery as :class:`proxmin_tpu.nmf.WeightedPGMStepper` at
    stride 1.
    """
    from . import operators as _ops
    from .nmf import (
        _lam_max_psd_batch, _weighted_lipschitz_S,
        _weighted_lipschitz_S_v0, grad_likelihood,
    )
    from .utils import fixed_point_converged

    pA = prox_A if prox_A is not None else _ops.prox_plus
    pS = prox_S if prox_S is not None else _ops.prox_plus

    def lam_max(G, iters=24):
        # power iteration on the tiny K-by-K Gram: pure matvec/elementwise
        # ops, which compose safely with vmap (step_pgm's exact
        # single-problem path, jnp.linalg.eigvalsh, batches poorly)
        k = G.shape[0]
        v = jnp.ones((k,), G.dtype) + 0.01 * jnp.arange(k, dtype=G.dtype)

        def body(_, v):
            w = jnp.dot(G, v, precision=TINY_PRECISION)
            return w * jax.lax.rsqrt(jnp.maximum(jnp.sum(w * w),
                                                 jnp.finfo(G.dtype).tiny))

        v = jax.lax.fori_loop(0, iters, body, v)
        return (v @ jnp.dot(G, v, precision=TINY_PRECISION)) / jnp.maximum(jnp.sum(v * v),
                                         jnp.finfo(G.dtype).tiny)

    def solve_unweighted(A0, S0, Y):
        def body(c):
            A, S, it, _ = c
            gA, gS = grad_likelihood(A, S, Y=Y)
            sA = 1.0 / lam_max(jnp.dot(S, S.T,
                                       precision=STREAM_PRECISION))
            sS = 1.0 / lam_max(jnp.dot(A.T, A,
                                       precision=TINY_PRECISION))
            A_new = pA(A - sA * gA, sA)
            S_new = pS(S - sS * gS, sS)
            conv = jnp.logical_and(
                fixed_point_converged(A_new, A, e_rel),
                fixed_point_converged(S_new, S, e_rel),
            )
            return A_new, S_new, it + 1, conv

        def cond(c):
            return jnp.logical_and(c[2] < max_iter, jnp.logical_not(c[3]))

        A, S, it, conv = jax.lax.while_loop(
            cond, body, (A0, S0, jnp.int32(0), jnp.asarray(False))
        )
        return A, S, it, conv

    def solve_weighted(A0, S0, Y, W):
        def body(c):
            A, S, v, it, _ = c
            gA, gS = grad_likelihood(A, S, Y=Y, W=W)
            H = jnp.einsum("kn,cn,ln->ckl", S, W, S,
                           precision=STREAM_PRECISION)
            LA = _lam_max_psd_batch(H, cold_iters)
            LS, v = _weighted_lipschitz_S(
                A, W, jnp.where(it == 0, cold_iters, warm_iters),
                v0=v, return_v=True,
            )
            sA = safety / LA
            sS = safety / LS
            A_new = pA(A - sA * gA, sA)
            S_new = pS(S - sS * gS, sS)
            conv = jnp.logical_and(
                fixed_point_converged(A_new, A, e_rel),
                fixed_point_converged(S_new, S, e_rel),
            )
            return A_new, S_new, v, it + 1, conv

        def cond(c):
            return jnp.logical_and(c[3] < max_iter, jnp.logical_not(c[4]))

        v0 = _weighted_lipschitz_S_v0(S0.shape[1], A0.shape[1],
                                      jnp.result_type(A0, S0, W))
        A, S, _, it, conv = jax.lax.while_loop(
            cond, body, (A0, S0, v0, jnp.int32(0), jnp.asarray(False))
        )
        return A, S, it, conv

    return with_matmul_precision(
        solve_weighted if weighted else solve_unweighted)
