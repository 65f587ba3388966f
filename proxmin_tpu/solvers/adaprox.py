"""AdaProx — adaptive proximal gradient (Adam family) with prox sub-iterations.

accelerator-native re-design of the reference ``adaprox``
(``proxmin/algorithms.py:147-423``; Melchior, Joseph & Moolekamp Algorithm 1,
arXiv:1910.10094): six adaptive schemes (Adam, NAdam, AMSGrad, PAdam,
AdamX, RAdam) expressed as pure Φ/Ψ functions over the moment state, with
a **nested** ``lax.while_loop`` solving the scaled proximal problem per
block (the reference's prox sub-iterations, ``algorithms.py:386-393``).

Moments M/V/Vhat live in the carry, which both keeps the whole solve
on-device and gives warm-start/continuation for free (pass ``M=``, ``V=``,
``Vhat=`` like the reference).

Deliberate fix vs the reference: with the default ``Vhat=None`` the
reference never writes the running max back into its ``Vhat`` list
(``algorithms.py:357`` initializes ``[None]*N`` and the Φ/Ψ functions only
rebind a local), so AMSGrad/PAdam/AdamX silently degrade to
non-accumulating variants unless the caller passes explicit ``Vhat``
arrays. Here ``Vhat`` initializes to zeros and always accumulates — the
published algorithms, and identical to the reference when it is given
``Vhat=0`` explicitly (which is how the parity tests pin it).
"""

import logging
from typing import Any, NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from .. import utils
from ..utils import (make_stepper, fixed_point_norms,
                     fixed_point_verdict, l2sq)
from .common import (
    DriverCache,
    SolverResult,
    abstract_key,
    cacheable,
    callable_key,
    grad_from_f,
    normalize_per_block,
    normalize_prox,
    separable_blocks,
    split_partial_data,
    split_stepper_data,
    tupleize,
    writeback,
    zeros_like_shapes,
)

logger = logging.getLogger("proxmin")

__all__ = ["adaprox", "SCHEMES"]


# ---------------------------------------------------------------------------
# Φ/Ψ schemes. Uniform signature:
#   (it, G, M, V, Vhat, b1, b2, eps, p, it0=0) -> (Phi, Psi, M', V', Vhat')
# b1 is the per-iteration schedule array (indexed by the LOCAL iteration
# ``it`` — on a warm restart the caller supplies the continuation slice);
# ``it0`` is the global iteration offset (warm restart), entering only the
# bias-correction clock t = it + it0 + 1 so a resumed solve continues the
# Adam bias-correction schedule instead of re-firing the t=1 transient.
# All return values are jnp arrays.

def _moments(it, G, M, V, b1, b2):
    M_new = (1 - b1[it]) * G + b1[it] * M
    V_new = (1 - b2) * (G ** 2) + b2 * V
    return M_new, V_new


def _adam_phi_psi(it, G, M, V, Vhat, b1, b2, eps, p, it0=0):
    M, V = _moments(it, G, M, V, b1, b2)
    t = it + it0 + 1
    Phi = M / (1 - b1[it] ** t)
    Psi = jnp.sqrt(V / (1 - b2 ** t)) + eps
    return Phi, Psi, M, V, Vhat


def _nadam_phi_psi(it, G, M, V, Vhat, b1, b2, eps, p, it0=0):
    M, V = _moments(it, G, M, V, b1, b2)
    t = it + it0 + 1
    Phi = (b1[it] * M + (1 - b1[it]) * G) / (1 - b1[it] ** t)
    Psi = jnp.sqrt(V / (1 - b2 ** t)) + eps
    return Phi, Psi, M, V, Vhat


def _amsgrad_phi_psi(it, G, M, V, Vhat, b1, b2, eps, p, it0=0):
    M, V = _moments(it, G, M, V, b1, b2)
    Vhat = jnp.maximum(Vhat, V)
    # eps clamps the *returned* Psi only, not the stored Vhat
    # (reference rebinds the local, algorithms.py:181-183)
    Psi = jnp.sqrt(jnp.maximum(Vhat, eps)) if eps > 0 else jnp.sqrt(Vhat)
    return M, Psi, M, V, Vhat


def _padam_phi_psi(it, G, M, V, Vhat, b1, b2, eps, p, it0=0):
    M, V = _moments(it, G, M, V, b1, b2)
    Vhat = jnp.maximum(Vhat, V)
    Psi = (jnp.maximum(Vhat, eps) if eps > 0 else Vhat) ** p
    return M, Psi, M, V, Vhat


def _adamx_phi_psi(it, G, M, V, Vhat, b1, b2, eps, p, it0=0):
    M, V = _moments(it, G, M, V, b1, b2)
    # factor irrelevant at it == 0 when Vhat starts at 0 (max picks V);
    # clamp the index so the schedule isn't read out of bounds
    prev = jnp.maximum(it - 1, 0)
    factor = (1 - b1[it]) ** 2 / (1 - b1[prev]) ** 2
    Vhat = jnp.maximum(factor * Vhat, V)
    Psi = jnp.sqrt(jnp.maximum(Vhat, eps)) if eps > 0 else jnp.sqrt(Vhat)
    return M, Psi, M, V, Vhat


def _radam_phi_psi(it, G, M, V, Vhat, b1, b2, eps, p, it0=0):
    rho_inf = 2 / (1 - b2) - 1
    M, V = _moments(it, G, M, V, b1, b2)
    t = it + it0 + 1
    Phi = M / (1 - b1[it] ** t)
    rho = rho_inf - 2 * t * b2 ** t / (1 - b2 ** t)

    # both branches computed, selected by where (rho is a traced scalar);
    # the rectification sqrt argument is clamped so the untaken branch
    # can't poison the select with NaN
    r_arg = (rho - 4) * (rho - 2) * rho_inf / (rho_inf - 4) / (rho_inf - 2) / rho
    r = jnp.sqrt(jnp.maximum(r_arg, jnp.finfo(V.dtype).tiny))
    Psi_rect = jnp.sqrt(V / (1 - b2 ** t)) / r
    Psi = jnp.where(rho > 4, Psi_rect, jnp.ones_like(V))
    if eps > 0:
        Psi = jnp.maximum(Psi, jnp.sqrt(eps))
    return Phi, Psi, M, V, Vhat


SCHEMES = {
    "adam": _adam_phi_psi,
    "nadam": _nadam_phi_psi,
    "amsgrad": _amsgrad_phi_psi,
    "padam": _padam_phi_psi,
    "adamx": _adamx_phi_psi,
    "radam": _radam_phi_psi,
}


_ADAPROX_CACHE = DriverCache()


def normalize_b1_schedule(b1, max_iter):
    """Broadcast/validate the per-iteration b1 schedule (reference
    ``algorithms.py:327-336``): host-side so it also works under an
    ambient trace, and strict about length (a short schedule would
    silently clamp via JAX's out-of-bounds gather). Shared by the
    driver, ``functional.make_adaprox_solver`` and the AOT exporter."""
    if not hasattr(b1, "__iter__"):
        b1 = np.full((max_iter,), b1, dtype=np.float64)
    if not isinstance(b1, jax.core.Tracer):
        # np.asarray also gives list/tuple schedules a .shape
        b1 = np.asarray(b1)
        assert (b1 >= 0).all() and (b1 < 1).all()
    assert b1.shape[0] == max_iter
    return jnp.asarray(b1)


def make_adaprox_cond(check_convergence, max_iter):
    """The driver's while-loop condition — shared with the AOT export
    path so exported artifacts cannot drift from the in-process
    solver."""
    def cond(s):
        not_done = jnp.logical_not(jnp.all(s.converged)) \
            if check_convergence else True
        go = jnp.logical_and(s.it < max_iter, not_done)
        return jnp.logical_and(go, jnp.logical_not(s.diverged))

    return cond


def init_adaprox_state(x0, M0, V0, Vhat0, stepper, grad, n, max_iter,
                       trace, it0=None, stepper_state=None,
                       resume_flags=None):
    """Initial carry construction — shared with the AOT export path.

    ``it0``/``stepper_state`` warm-restart the global iteration clock and
    the stepper (e.g. strided-refresh intervals) from a previous solve's
    ``.state`` (see :func:`adaprox`'s ``state=``). ``resume_flags`` is
    the carried ``(converged, diverged)`` pair — a solve that STOPPED
    stays stopped on resume (see pgm's resume_state note)."""
    G0 = zeros_like_shapes(lambda *x: utils._as_tuple(grad(*x)), *x0)
    fresh_sst = stepper.init_state(x0, G0)
    if stepper_state is None:
        stepper_state = fresh_sst
    elif jax.tree_util.tree_structure(stepper_state) != \
            jax.tree_util.tree_structure(fresh_sst):
        raise ValueError(
            "state= was produced under a different step configuration "
            "(stepper state structure mismatch); resume with the same "
            "step arguments"
        )
    return AdaProxState(
        x=tuple(jnp.array(x, copy=True) for x in x0),
        M=M0,
        V=V0,
        Vhat=Vhat0,
        stepper_state=stepper_state,
        it=jnp.int32(0),
        converged=(jnp.asarray(resume_flags[0], bool).reshape((n,))
                   if resume_flags is not None
                   else jnp.zeros((n,), bool)),
        sub_iters=jnp.zeros((n,), jnp.int32),
        history=jnp.zeros(
            (max_iter if trace else 0, n),
            jnp.result_type(*[x.dtype for x in x0], jnp.float32),
        ),
        diverged=(jnp.asarray(resume_flags[1], bool)
                  if resume_flags is not None else jnp.asarray(False)),
        it0=(jnp.int32(0) if it0 is None else jnp.asarray(it0, jnp.int32)),
    )


class AdaProxState(NamedTuple):
    x: tuple
    M: tuple
    V: tuple
    Vhat: tuple
    stepper_state: Any
    it: Any
    converged: Any       # (N,) bool
    sub_iters: Any       # (N,) int32, cumulative prox sub-iterations
    history: Any         # (max_iter, N) relative residuals (trace mode)
    diverged: Any        # bool — a non-finite iterate was produced
    it0: Any             # global iteration offset (warm restart): the
                         # Adam bias-correction clock and the stepper see
                         # it + it0; b1 schedule indexing, history and
                         # max_iter use the local it


def _prox_subloop(prox_j, x_j, alpha_j, Psi, e_rel_j, prox_max_iter):
    """Solve the scaled proximal problem by fixed-point sub-iterations
    (reference ``algorithms.py:382-400``):
    ``z <- prox(z - (gamma/alpha) Psi (z - x_j), gamma)`` with
    ``gamma = alpha / max(Psi)``, until
    ``||z' - z||^2 <= e_rel^2 ||z||^2``. Returns ``(z, tau)``.
    """
    psi_max = jnp.max(Psi)
    gamma = alpha_j / psi_max
    scale = Psi / psi_max   # == (gamma / alpha) * Psi elementwise

    def cond(carry):
        z, tau, done = carry
        return jnp.logical_and(jnp.logical_not(done), tau < prox_max_iter)

    def body(carry):
        z, tau, _ = carry
        z_new = prox_j(z - scale * (z - x_j), gamma)
        done = l2sq(z_new - z) <= e_rel_j ** 2 * l2sq(z)
        return z_new, tau + 1, done

    z, tau, _ = jax.lax.while_loop(
        cond, body, (x_j, jnp.int32(0), jnp.asarray(False))
    )
    return z, tau


def _make_adaprox_body(grad, stepper, prox, has_prox, phi_psi, b1, b2, eps,
                       p, e_rel, check_convergence, prox_max_iter,
                       trace=False, separable=None, moment_dtype=None):
    n = len(prox)
    if separable is None:
        separable = (False,) * n

    def body(state: AdaProxState) -> AdaProxState:
        it = state.it
        it_g = it + state.it0  # global clock (differs after warm restart)
        G = utils._as_tuple(grad(*state.x))
        Alpha, stepper_state = stepper(state.stepper_state, state.x, it_g, G)
        Alpha = tuple(jnp.asarray(a) for a in Alpha)

        x_new, M_new, V_new, Vhat_new = [], [], [], []
        sub_iters = state.sub_iters
        for j in range(n):
            # the b1 schedule array is host-built in f64, and a Python
            # b2 raised to the traced power t promotes to the default
            # float; cast both to the block dtype so f32 iterates stay
            # f32 under enabled x64
            dt = state.x[j].dtype
            # moment_dtype (e.g. bf16) halves the moment HBM traffic —
            # the carry STORES reduced precision, the EMA/bias math
            # computes in the block dtype (cast up here, down on store)
            Mj_in, Vj_in, Vhatj_in = (
                (state.M[j].astype(dt), state.V[j].astype(dt),
                 state.Vhat[j].astype(dt))
                if moment_dtype is not None
                else (state.M[j], state.V[j], state.Vhat[j])
            )
            Phi, Psi, Mj, Vj, Vhatj = phi_psi(
                it, G[j], Mj_in, Vj_in, Vhatj_in,
                b1.astype(dt), jnp.asarray(b2, dt), eps, p,
                it0=state.it0,
            )
            if moment_dtype is not None:
                Mj = Mj.astype(moment_dtype)
                Vj = Vj.astype(moment_dtype)
                Vhatj = Vhatj.astype(moment_dtype)
            xj = state.x[j] - Alpha[j] * Phi / Psi

            if has_prox[j] and separable[j]:
                # separable (convex elementwise) prox: the scaled prox
                # problem decomposes per element into prox with step
                # alpha / Psi_i — its EXACT closed form; one application
                # replaces the sub-iteration loop (and is what the
                # sub-loop converges to)
                gamma_el = Alpha[j] / jnp.maximum(
                    Psi, jnp.finfo(Psi.dtype).tiny
                )
                xj = prox[j](xj, gamma_el)
                sub_iters = sub_iters.at[j].add(1)
            elif has_prox[j]:
                xj, tau = _prox_subloop(
                    prox[j], xj, Alpha[j], Psi, e_rel[j], prox_max_iter
                )
                sub_iters = sub_iters.at[j].add(tau)

            x_new.append(xj)
            M_new.append(Mj)
            V_new.append(Vj)
            Vhat_new.append(Vhatj)

        history = state.history
        if check_convergence or trace:
            # reuse one pair of reductions per block for the convergence
            # test, the divergence detector and the trace residual
            norms = [fixed_point_norms(x_new[j], state.x[j])
                     for j in range(n)]
            verdicts = [fixed_point_verdict(d, nx, e_rel[j])
                        for j, (d, nx) in enumerate(norms)]
            converged = (jnp.stack([c for c, _ in verdicts])
                         if check_convergence else state.converged)
            finite = jnp.stack([fin for _, fin in verdicts]).all()
            if trace:
                res = jnp.stack([
                    jnp.sqrt(d / jnp.maximum(nx, 1e-30))
                    for d, nx in norms
                ])
                history = history.at[it].set(res.astype(history.dtype))
        else:
            converged = state.converged
            finite = jnp.stack([
                jnp.all(jnp.isfinite(x_new[j])) for j in range(n)
            ]).all()

        return AdaProxState(
            x=tuple(x_new),
            M=tuple(M_new),
            V=tuple(V_new),
            Vhat=tuple(Vhat_new),
            stepper_state=stepper_state,
            it=it + 1,
            converged=converged,
            sub_iters=sub_iters,
            history=history,
            diverged=jnp.logical_or(state.diverged, jnp.logical_not(finite)),
            it0=state.it0,
        )

    return body


@utils.with_matmul_precision
def adaprox(
    X,
    grad,
    step,
    prox=None,
    scheme="adam",
    b1=0.9,
    b2=0.999,
    eps=1e-8,
    check_convergence=True,
    p=0.25,
    e_rel=1e-6,
    max_iter=1000,
    prox_max_iter=1000,
    M=None,
    V=None,
    Vhat=None,
    callback=None,
    trace=False,
    f=None,
    separable_prox=False,
    moment_dtype=None,
    state=None,
):
    """Adaptive Proximal Gradient Method (proximal Adam family).

    Drop-in equivalent of the reference ``proxmin.adaprox``
    (``algorithms.py:248-423``): Adam (Kingma & Ba 2015), NAdam (Dozat
    2016), AMSGrad (Reddi+ 2018), PAdam (Chen & Gu 2018), AdamX (Phuong &
    Phong 2019), RAdam (Liu+ 2019), each followed by PGM sub-iterations
    to restore feasibility/optimality (arXiv:1910.10094 Algorithm 1).

    Setting ``M``, ``V``, ``Vhat`` warm-starts from a previous run's
    moments (returned by this function), e.g. to continue a slightly
    changed problem — the reference's warm-start surface
    (``algorithms.py:347-359``), which resets the bias-correction clock.

    ``state``: EXACT warm restart from a previous solve's ``.state``
    (pairs with passing the previous ``X``, like the other four solver
    families): moments, the global Adam bias-correction clock ``t``, and
    stepper state (strided-refresh intervals, BB history) all continue,
    so a killed-and-resumed solve reproduces the uninterrupted
    trajectory exactly — unlike ``M=/V=/Vhat=``, which re-fires the
    ``t=1`` bias-correction transient. Mutually exclusive with
    ``M=/V=/Vhat=``. With a scheduled (non-scalar) ``b1``, pass the
    continuation slice of the schedule. Round-trips through
    :mod:`proxmin_tpu.checkpoint`. No reference analogue.

    ``grad=None`` with ``f=<smooth function>`` differentiates ``f`` via
    ``jax.grad`` (the accelerator-native successor of the reference's autograd
    compatibility).

    ``separable_prox``: for convex elementwise proxs the scaled proximal
    problem has the exact closed form ``prox(x, alpha/Psi)`` per element
    — one application instead of the reference's sub-iteration loop
    (arXiv:1910.10094 Alg. 1), both faster (3.2x at the NMF flagship
    shape) and exact rather than ``e_rel``-truncated. ``True`` asserts
    every block's prox admits the closed form (the per-element step must
    mean what the operator expects); ``"auto"`` consults the library
    operators' ``separable_when`` predicates over their bound keywords —
    plus/id/zero always; min/max only with ``type="absolute"`` or
    ``thresh=0``; soft/soft_plus/max_entropy only with
    ``type="relative"``; hard excluded (L0 is nonconvex). Default
    ``False`` preserves exact reference-iterate parity.

    ``moment_dtype`` (e.g. ``jnp.bfloat16``) stores the M/V/Vhat moment
    arrays in reduced precision in the solver carry: the EMA/bias math
    still computes in the iterate dtype (cast up per iteration, down on
    store). This is a CAPACITY option — moment memory halves for
    problems near the device's memory limit; the casts are extra passes,
    so it need not be faster than f32. Moment EMAs
    carry bf16 rounding (~3 decimal digits); iterates/convergence tests
    stay full precision. Default ``None`` = iterate dtype (parity).

    Returns:
        ``SolverResult`` unpacking as ``(converged, M, V, Vhat)`` like the
        reference, with attributes ``.x``, ``.iterations``,
        ``.sub_iterations``.
    """
    x0, originals, was_single = tupleize(X)
    n = len(x0)
    if grad is None:
        assert f is not None, "grad=None requires f"
        grad = grad_from_f(f, n)
    prox_in = utils._as_tuple(prox)
    if len(prox_in) == 1:
        prox_in = prox_in * n
    assert len(prox_in) == n
    # the reference only runs sub-iterations for blocks whose prox is not
    # None (algorithms.py:380); remember which before normalization
    has_prox = tuple(pj is not None for pj in prox_in)
    prox = normalize_prox(prox_in, n)
    e_rel = normalize_per_block(e_rel, n)

    separable = separable_blocks(prox_in, has_prox, separable_prox)

    b1 = normalize_b1_schedule(b1, max_iter)
    assert 0 <= b2 < 1
    assert eps >= 0
    assert 0 < p <= 0.5
    scheme = scheme.lower()
    assert scheme in SCHEMES, f"unknown scheme {scheme!r}"
    phi_psi = SCHEMES[scheme]

    # cold or warm start for the moments. Cold starts stay None here and
    # materialize as zeros INSIDE the compiled run (an eager zeros per
    # moment block costs a device dispatch per solve); warm starts are
    # validated eagerly (shape metadata only, no transfer) and converted
    # in-graph (jit outputs never alias the caller's arrays).
    def init_moments(given):
        if given is None:
            return None
        given = utils._as_tuple(given)
        assert len(given) == n
        # lists/tuples become single array leaves (a raw list would ride
        # the jit boundary as a pytree of scalars)
        given = tuple(
            g if hasattr(g, "shape") else np.asarray(g) for g in given
        )
        for g, x in zip(given, x0):
            assert g.shape == x.shape
        return tuple(given)

    def moments_as_arrays(given, xs):
        """Concrete (traced or eager) moment blocks from user input,
        in the storage dtype (``moment_dtype`` or the block dtype)."""
        if given is None:
            return tuple(
                jnp.zeros(x.shape, moment_dtype or x.dtype) for x in xs
            )
        return tuple(
            jnp.array(g, copy=True, dtype=moment_dtype or x.dtype)
            for g, x in zip(given, xs)
        )

    if state is not None:
        assert M is None and V is None and Vhat is None, \
            "state= (exact resume) and M=/V=/Vhat= (moment warm start) " \
            "are mutually exclusive"
        M, V, Vhat = state["M"], state["V"], state["Vhat"]
        resume = {"stepper_state": state["stepper_state"],
                  "it": jnp.asarray(state["it"], jnp.int32),
                  # terminal flags (absent on pre-r4-final checkpoints:
                  # default "not stopped"): a stopped solve stays stopped
                  "converged": jnp.asarray(
                      state.get("converged", np.zeros(n, bool)), bool),
                  "diverged": jnp.asarray(
                      state.get("diverged", False), bool)}
    else:
        resume = None

    M0 = init_moments(M)
    V0 = init_moments(V)
    Vhat0 = init_moments(Vhat)

    stepper = make_stepper(step, n)

    from .pgm import _stepper_cache_key

    key = ("adaprox", callable_key(grad), _stepper_cache_key(step, stepper),
           tuple(callable_key(p) for p in prox), has_prox, separable, scheme,
           float(b2), float(eps), float(p), e_rel, check_convergence,
           max_iter, prox_max_iter, trace, callback is None,
           hash(np.asarray(b1).tobytes()),  # b1 schedule is a trace constant
           str(moment_dtype) if moment_dtype is not None else None,
           abstract_key(x0))

    # large partial-bound data rides as jit arguments, not trace
    # constants (see common.split_partial_data and the pgm driver)
    grad_rb, grad_lv = split_partial_data(grad)
    prox_pairs = tuple(split_partial_data(pj) for pj in prox)
    prox_rbs = tuple(pp[0] for pp in prox_pairs)
    prox_lv = tuple(pp[1] for pp in prox_pairs)
    stepper_rb, step_lv = split_stepper_data(step, stepper, n)

    data_leaves = (grad_lv, step_lv, prox_lv)

    def build():
        def make_parts(leaves):
            g = grad_rb(leaves[0])
            st = stepper_rb(leaves[1])
            pr = tuple(rb(lv) for rb, lv in zip(prox_rbs, leaves[2]))
            body = _make_adaprox_body(
                g, st, pr, has_prox, phi_psi, b1, b2, eps, p, e_rel,
                check_convergence, prox_max_iter, trace=trace,
                separable=separable, moment_dtype=moment_dtype,
            )
            return body, g, st

        if callback is None:
            # the initial state (incl. cold-start zero moments) is built
            # INSIDE the executable — eager construction dispatches ~a
            # dozen host->device ops per solve (see the pgm driver)
            def run(x, moments, leaves, resume):
                body, g, st = make_parts(leaves)
                M0_ = moments_as_arrays(moments[0], x)
                V0_ = moments_as_arrays(moments[1], x)
                Vhat0_ = moments_as_arrays(moments[2], x)
                state = init_adaprox_state(
                    x, M0_, V0_, Vhat0_, st, g, n, max_iter, trace,
                    it0=None if resume is None else resume["it"],
                    stepper_state=(None if resume is None
                                   else resume["stepper_state"]),
                    resume_flags=(None if resume is None else
                                  (resume.get("converged", np.zeros(n, bool)),
                                   resume.get("diverged", False))),
                )
                cond = make_adaprox_cond(check_convergence, max_iter)
                return jax.lax.while_loop(cond, body, state)

            # not donated, like the pgm driver
            return stepper, jax.jit(run)
        return stepper, jax.jit(lambda s, leaves: make_parts(leaves)[0](s))

    if cacheable(key):
        cached_stepper, compiled = _ADAPROX_CACHE.get_or_build(key, build)
    else:
        # e.g. a mutable NumPy step array: retrace per call (always
        # correct), mirroring the ADMM/bSDMM drivers' cacheable() bypass
        cached_stepper, compiled = build()

    def init_state():
        return init_adaprox_state(
            x0, moments_as_arrays(M0, x0), moments_as_arrays(V0, x0),
            moments_as_arrays(Vhat0, x0), cached_stepper, grad,
            n, max_iter, trace,
            it0=None if resume is None else resume["it"],
            stepper_state=(None if resume is None
                           else resume["stepper_state"]),
            resume_flags=(None if resume is None else
                          (resume.get("converged", np.zeros(n, bool)),
                           resume.get("diverged", False))),
        )

    if callback is None:
        state = compiled(tuple(x0), (M0, V0, Vhat0), data_leaves, resume)
    else:
        step_fn = compiled
        state = init_state()
        for it in range(max_iter):
            try:
                callback(*[np.asarray(x) for x in state.x], it=it)
            except StopIteration:
                break
            state = step_fn(state, data_leaves)
            if bool(state.diverged) or (
                    check_convergence and bool(jnp.all(state.converged))):
                break

    # one batched device->host fetch (separate transfers pay one round
    # trip each)
    it_h, sub_h, div_h, conv_h = jax.device_get(
        (state.it, state.sub_iters, state.diverged, state.converged)
    )
    iterations = int(it_h)
    sub_iterations = tuple(int(s) for s in sub_h)
    logger.info(
        "Completed %d iterations and %s sub-iterations",
        iterations, list(sub_iterations),
    )
    diverged = bool(div_h)
    if check_convergence:
        converged = tuple(bool(c) for c in conv_h)
        if not diverged and not all(converged):
            logger.warning("Solution did not converge")
    else:
        converged = (None,) * n
    if diverged:
        status = "diverged"
        logger.warning("Solution diverged (non-finite iterate)")
    elif check_convergence and all(converged):
        status = "converged"
    else:
        status = "max_iter"

    writeback(originals, state.x)
    x_out = state.x[0] if was_single else state.x
    history = np.asarray(state.history[:iterations]) if trace else None
    # exact warm-restart pytree (see `state=`): moments + the global
    # bias-correction clock + stepper state
    resume_state = {
        "M": state.M, "V": state.V, "Vhat": state.Vhat,
        "stepper_state": state.stepper_state,
        "it": state.it + state.it0,
        # terminal flags: a stopped solve stays stopped on resume (see
        # pgm's resume_state note)
        "converged": state.converged, "diverged": state.diverged,
    }
    return SolverResult(
        (converged, state.M, state.V, state.Vhat),
        x=x_out, iterations=iterations, converged=converged,
        sub_iterations=sub_iterations,
        M=state.M, V=state.V, Vhat=state.Vhat, history=history,
        status=status, state=resume_state,
    )
