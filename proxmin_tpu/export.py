"""AOT export of solver executables for production serving.

A deployed service should not pay tracing + compilation at request time.
:func:`export_nmf_solver` serializes the fused PGM-NMF solve (StableHLO via
``jax.export``) for fixed problem shapes; :func:`load_solver` restores it in
a fresh process (no proxmin_tpu import needed at serving time beyond jax)
and returns a callable ``(A0, S0, Y, max_iter) -> (A, S, it, conv_A,
conv_S, loss)``.

:func:`export_pgm_solver` and :func:`export_adaprox_solver` serialize the
generic drivers for arbitrary user problems (fixed block shapes + jittable
``grad``/``step``/``prox`` callables). Arrays closed over by the callables
(e.g. the data matrix inside a gradient closure) are baked into the
artifact as constants — pass per-request data as solver *blocks*, or
export per dataset.

:func:`export_admm_solver`, :func:`export_sdmm_solver` and
:func:`export_bsdmm_solver` do the same for the ADMM family: the linear
operators (their matrices) and any closure-captured data are baked into
the artifact, so every solver in the package is AOT-servable.

The exported artifact is shape- and platform-specialized (an artifact
exported on a CUDA GPU runs on one). The fused NMF artifacts embed the
Pallas kernels as Triton calls, whose IR is tied to the JAX version that
wrote them: re-export after upgrading JAX. For multi-shape serving, export
one artifact per shape bucket.
"""

import jax

from .utils import with_matmul_precision
import jax.numpy as jnp
from jax import export as jax_export

from . import operators
from .ops.nmf_kernels import pixel_tile
from .nmf import (
    _make_fused_adaprox_runner,
    _make_fused_pgm_runner,
    _make_fused_weighted_pgm_runner,
)

#: The fused kernels lower to this custom call on CUDA; ``jax.export``
#: serializes it only when told to (its IR carries no stability promise).
_TRITON_CALL = jax_export.DisabledSafetyCheck.custom_call(
    "__gpu$xla.gpu.triton")

__all__ = [
    "export_nmf_solver", "export_nmf_adaprox_solver",
    "export_nmf_pgm_sharded", "export_nmf_adaprox_sharded",
    "export_pgm_solver", "export_adaprox_solver",
    "export_admm_solver", "export_sdmm_solver", "export_bsdmm_solver",
    "load_solver", "save_exported", "load_exported",
]


def _block_shapes(x_shapes):
    """Normalize a shape or list of shapes into a tuple of block shapes."""
    if len(x_shapes) > 0 and isinstance(x_shapes[0], int):
        x_shapes = [x_shapes]
    return tuple(tuple(int(d) for d in s) for s in x_shapes)


@with_matmul_precision
def export_pgm_solver(x_shapes, grad, step, prox=None, accelerated=False,
                      restart=False, backtracking=False, f=None,
                      e_rel=1e-6, max_iter=1000, dtype=jnp.float32):
    """Serialize a :func:`proxmin_tpu.pgm` solve for fixed block shapes.

    ``x_shapes``: one shape tuple or a list of per-block shapes. The
    embedded executable takes the initial blocks and returns
    ``(x_blocks, iterations, converged, diverged)``.
    """
    from .solvers.common import normalize_per_block, normalize_prox
    from .solvers.pgm import _init_state, _make_pgm_body, _run_fused
    from .utils import make_stepper

    shapes = _block_shapes(x_shapes)
    n = len(shapes)
    prox_t = normalize_prox(prox, n)
    e_rel_t = normalize_per_block(e_rel, n)
    assert backtracking is False or f is not None
    stepper = make_stepper(step, n)
    body = _make_pgm_body(grad, stepper, prox_t, e_rel_t, accelerated,
                          backtracking, f, restart=restart)

    def run(*x0):
        state = _init_state(x0, grad, stepper, n, max_iter, False,
                            accelerated)
        st = _run_fused(state, body, max_iter, n)
        return st.x, st.it, st.converged, st.diverged

    args = tuple(jax.ShapeDtypeStruct(s, dtype) for s in shapes)
    return jax_export.export(jax.jit(run))(*args).serialize()


@with_matmul_precision
def export_adaprox_solver(x_shapes, grad, step, prox=None, scheme="adam",
                          b1=0.9, b2=0.999, eps=1e-8, p=0.25,
                          check_convergence=True, e_rel=1e-6, max_iter=1000,
                          prox_max_iter=1000, dtype=jnp.float32):
    """Serialize a :func:`proxmin_tpu.adaprox` solve for fixed block
    shapes (cold-started moments). Returns
    ``(x_blocks, M, V, Vhat, iterations, converged, diverged)``.
    """
    from .solvers.adaprox import (
        SCHEMES, _make_adaprox_body, init_adaprox_state, make_adaprox_cond,
        normalize_b1_schedule,
    )
    from .solvers.common import normalize_per_block, normalize_prox
    from . import utils as _utils
    from .utils import make_stepper

    shapes = _block_shapes(x_shapes)
    n = len(shapes)
    prox_in = _utils._as_tuple(prox)
    if len(prox_in) == 1:
        prox_in = prox_in * n
    has_prox = tuple(pj is not None for pj in prox_in)
    prox_t = normalize_prox(prox_in, n)
    e_rel_t = normalize_per_block(e_rel, n)
    b1 = normalize_b1_schedule(b1, max_iter)
    phi_psi = SCHEMES[scheme.lower()]
    stepper = make_stepper(step, n)
    body = _make_adaprox_body(grad, stepper, prox_t, has_prox, phi_psi,
                              b1, b2, eps, p, e_rel_t, check_convergence,
                              prox_max_iter)

    def run(*x0):
        # shared with the in-process driver so artifacts cannot drift
        zeros = tuple(jnp.zeros_like(x) for x in x0)
        state = init_adaprox_state(x0, zeros, zeros, zeros, stepper, grad,
                                   n, max_iter, trace=False)
        cond = make_adaprox_cond(check_convergence, max_iter)
        st = jax.lax.while_loop(cond, body, state)
        return st.x, st.M, st.V, st.Vhat, st.it, st.converged, st.diverged

    args = tuple(jax.ShapeDtypeStruct(s, dtype) for s in shapes)
    return jax_export.export(jax.jit(run))(*args).serialize()


@with_matmul_precision
def export_admm_solver(x_shape, prox_f, step_f, prox_g=None, step_g=None,
                       L=None, e_rel=1e-6, e_abs=0, max_iter=1000,
                       dtype=jnp.float32):
    """Serialize a :func:`proxmin_tpu.admm` solve for a fixed ``x_shape``.

    The linear operator ``L`` (if any) and closure-captured data are baked
    into the artifact as constants. The embedded executable takes the
    initial iterate and returns ``(x, iterations, converged, errors)``
    (``errors`` = the Boyd residual 4-tuple rows, shape ``(1, 4)``).
    """
    from .linop import as_linear_operator
    from .solvers.admm import _sdmm_core

    Lop = as_linear_operator(L)
    proxs_g = (prox_g,) if prox_g is not None else ()
    steps_g = (step_g,) if prox_g is not None else ()
    runner = _sdmm_core(
        None, prox_f, step_f, proxs_g, steps_g,
        (Lop,) if prox_g is not None else (),
        e_rel, e_abs, max_iter, None, return_errors=True,
        return_runner=True,
    )

    def run(x0):
        st = runner(x0)
        return st.x, st.it, st.converged, st.errors

    arg = jax.ShapeDtypeStruct(tuple(int(d) for d in x_shape), dtype)
    return jax_export.export(jax.jit(run))(arg).serialize()


@with_matmul_precision
def export_sdmm_solver(x_shape, prox_f, step_f, proxs_g, steps_g=None,
                       Ls=None, e_rel=1e-6, e_abs=0, max_iter=1000,
                       dtype=jnp.float32):
    """Serialize a :func:`proxmin_tpu.sdmm` solve (M constraints) for a
    fixed ``x_shape``. Returns ``(x, iterations, converged, errors)``
    (``errors`` shape ``(M, 4)``)."""
    from .linop import as_linear_operator
    from .solvers.admm import _sdmm_core

    proxs_g = tuple(proxs_g)
    M = len(proxs_g)
    if not hasattr(Ls, "__iter__"):
        Ls = [Ls] * M
    Lops = tuple(as_linear_operator(Li) for Li in Ls)
    steps_g = (None,) * M if steps_g is None else tuple(steps_g)
    runner = _sdmm_core(
        None, prox_f, step_f, proxs_g, steps_g, Lops,
        e_rel, e_abs, max_iter, None, return_errors=False,
        admm_convention=False, return_runner=True,
    )

    def run(x0):
        st = runner(x0)
        return st.x, st.it, st.converged, st.errors

    arg = jax.ShapeDtypeStruct(tuple(int(d) for d in x_shape), dtype)
    return jax_export.export(jax.jit(run))(arg).serialize()


@with_matmul_precision
def export_bsdmm_solver(x_shapes, proxs_f, steps_f_cb, proxs_g=None,
                        steps_g=None, Ls=None, update_order=None,
                        steps_g_update="steps_f", e_rel=1e-6, e_abs=0,
                        max_iter=1000, steps_f_stride=None,
                        dtype=jnp.float32):
    """Serialize a :func:`proxmin_tpu.bsdmm` solve for fixed block shapes.

    ``x_shapes``: one shape tuple or a list of per-block shapes. Returns
    ``(x_blocks, iterations, converged_per_block)``.
    """
    from .solvers.bsdmm import bsdmm

    shapes = _block_shapes(x_shapes)
    dummies = [jnp.zeros(s, dtype) for s in shapes]
    runner = bsdmm(
        dummies, proxs_f, steps_f_cb, proxs_g=proxs_g, steps_g=steps_g,
        Ls=Ls, update_order=update_order, steps_g_update=steps_g_update,
        max_iter=max_iter, e_rel=e_rel, e_abs=e_abs,
        steps_f_stride=steps_f_stride, _export_runner=True,
    )

    def run(*x_blocks):
        st = runner(*x_blocks)
        return st.x, st.it, st.converged

    args = tuple(jax.ShapeDtypeStruct(s, dtype) for s in shapes)
    return jax_export.export(jax.jit(run))(*args).serialize()


@with_matmul_precision
def export_nmf_solver(C, K, N, prox_A=operators.prox_plus,
                      prox_S=operators.prox_plus,
                      e_rel=1e-3, tile_n=None, dtype=jnp.float32,
                      store_dtype=None, weighted=False, step_stride=None,
                      step_adapt=False, resume=False,
                      return_carries=None):
    """Serialize the fused PGM-NMF solver for a fixed (C, K, N) shape.

    Returns the serialized bytes. The embedded executable has the
    signature ``(A: (C,K), S: (K,N), Y: (C,N), max_iter: i32)`` — or,
    with ``weighted=True``, ``(A, S, Y, W: (C,N), max_iter)`` using the
    weighted fused runner (warm-started strided Lipschitz refresh when
    ``step_stride`` is set; ``step_adapt=True`` bakes the in-carry
    adaptive stride growth). ``prox_S=None`` means identity (same
    convention as ``nmf``); ``step_adapt`` pairs with weighted;
    ``store_dtype`` works on both (weighted: S/Y/W all stored reduced).

    Artifact-only preemption (the single-chip mirror of
    :func:`export_nmf_pgm_sharded`'s ``resume=``): ``resume=True``
    exports the exact-continuation variant, whose carry inputs after
    ``max_iter`` are exactly a carry-returning artifact's OUTPUTS from
    position 2 on — ``it0: i32, conv_A: bool, conv_S: bool, loss:
    f32`` then the step state (unweighted: ``SSt: (K,K) f32``, the
    kernel Gram; weighted: ``step_A, step_S: f32, v: (N,K) f32,
    stride, next_refresh: i32``). ``return_carries=True`` (implied by
    ``resume``) appends those carries to the outputs, so a chain is
    ``fresh(return_carries=True)`` -> ``cont(..., max_iter2,
    *outs[2:])`` -> ... — bit-exact vs the uninterrupted solve, and a
    solve that already stopped (converged / nan-loss diverged) stays
    stopped. Default fresh artifacts keep the documented 6-output
    signature.
    """
    if step_adapt and not weighted:
        raise ValueError(
            "step_adapt applies to the weighted Lipschitz refresh only"
        )
    if prox_A is None:
        prox_A = operators.prox_id
    if prox_S is None:
        prox_S = operators.prox_id
    elif prox_S is operators.prox_plus:
        prox_S = None  # kernel builtin
    resume = bool(resume)
    weighted = bool(weighted)
    if return_carries is None:
        return_carries = resume
    tile_n = pixel_tile(int(K), int(N), tile_n)
    if weighted:
        run_full = _make_fused_weighted_pgm_runner(
            prox_A, prox_S, float(e_rel), tile_n, int(C), int(K),
            int(N), jnp.dtype(dtype), step_stride,
            adapt=bool(step_adapt),
            store_dtype=jnp.dtype(store_dtype) if store_dtype else None,
        )
    else:
        run_full = _make_fused_pgm_runner(
            prox_A, prox_S, float(e_rel), tile_n, int(C), int(K),
            int(N), jnp.dtype(dtype),
            store_dtype=jnp.dtype(store_dtype) if store_dtype else None,
        )

    def run(A, S, Y, *rest):
        if weighted:
            W, max_iter, *rargs = rest
            data = (A, S, Y, W, max_iter)
        else:
            max_iter, *rargs = rest
            data = (A, S, Y, max_iter)
        kw = {}
        it0 = jnp.int32(0)
        if resume:
            it0, cA0, cS0, loss0, *steps = rargs
            it0 = jnp.asarray(it0, jnp.int32)
            # a carried nan loss after >=1 prior iteration means the
            # solve already diverged — it stays stopped (fresh chains
            # start with it0=0, loss0=inf, which never trips this).
            # loss0 rides into the loop init, so a NO-OP link (zero
            # budget, already converged) outputs its real finite loss
            # and the next link in the chain still runs
            div0 = jnp.logical_and(
                it0 > 0, jnp.logical_not(jnp.isfinite(loss0)))
            kw = dict(conv_A0=cA0, conv_S0=cS0, div0=div0, loss0=loss0)
            if weighted:
                kw["it0"] = it0
                kw["steps0"] = tuple(steps)
            else:
                (kw["SSt0"],) = steps
        outs = run_full(*data, **kw)
        # global clock: the weighted runner counts from it0 already,
        # the unweighted one counts locally
        it_out = outs[2] if weighted and resume else outs[2] + it0
        head = (outs[0], outs[1], it_out) + tuple(outs[3:6])
        return head + (tuple(outs[6:]) if return_carries else ())

    f32 = jnp.dtype(jnp.float32)
    args = [
        jax.ShapeDtypeStruct((C, K), dtype),
        jax.ShapeDtypeStruct((K, N), dtype),
        jax.ShapeDtypeStruct((C, N), dtype),
    ]
    if weighted:
        args.append(jax.ShapeDtypeStruct((C, N), dtype))
    args.append(jax.ShapeDtypeStruct((), jnp.int32))
    if resume:
        args += [jax.ShapeDtypeStruct((), jnp.int32),    # it0
                 jax.ShapeDtypeStruct((), jnp.bool_),    # conv_A0
                 jax.ShapeDtypeStruct((), jnp.bool_),    # conv_S0
                 jax.ShapeDtypeStruct((), f32)]          # loss0
        if weighted:
            args += [jax.ShapeDtypeStruct((), f32),      # step_A
                     jax.ShapeDtypeStruct((), f32),      # step_S
                     jax.ShapeDtypeStruct((N, K), f32),  # v
                     jax.ShapeDtypeStruct((), jnp.int32),   # stride
                     jax.ShapeDtypeStruct((), jnp.int32)]   # next refresh
        else:
            args.append(jax.ShapeDtypeStruct((K, K), f32))  # SSt
    return jax_export.export(jax.jit(run), disabled_checks=[_TRITON_CALL])(
        *args).serialize()


@with_matmul_precision
def export_nmf_adaprox_solver(C, K, N, prox_A=operators.prox_plus,
                              prox_S=operators.prox_plus,
                              e_rel=1e-3, tile_n=None,
                              dtype=jnp.float32, b1=0.9, b2=0.999,
                              eps=1e-8, moment_dtype=None,
                              store_dtype=None,
                              warm_start=False, weighted=False,
                              resume=False, return_carries=None):
    """Serialize the fused proximal-Adam NMF solver (``scheme='adam'``,
    separable proxs — see :func:`proxmin_tpu.nmf.nmf_adaprox_fused`)
    for a fixed (C, K, N) shape.

    Executable signature ``(A, S, Y, max_iter) -> (A', S', it, conv_A,
    conv_S, loss, M_A, V_A, M_S, V_S)``; ``weighted=True`` inserts a
    ``W: (C,N)`` argument after ``Y`` (matching
    :func:`export_nmf_solver`'s weighted ordering); ``warm_start=True``
    appends ``M_A, V_A, M_S, V_S`` accepting a previous
    export's returned moments (continuation across serving processes;
    the bias-correction clock restarts, reference
    ``algorithms.py:347-359`` semantics). ``moment_dtype`` (e.g.
    ``jnp.bfloat16``) bakes the reduced-precision moment storage into
    the artifact.

    Artifact-only EXACT preemption (vs ``warm_start``'s
    clock-restarting reference semantics): ``resume=True`` exports the
    continuation variant whose carry inputs after ``max_iter`` are
    exactly a carry-returning artifact's OUTPUTS from position 2 on —
    ``it0, conv_A, conv_S, loss, M_A, V_A, M_S, V_S, rowsum: (K,) f32``
    (the kernel's step-heuristic row-sum carry). ``return_carries=True``
    (implied by ``resume``) appends ``rowsum`` to the outputs, so a
    chain is ``fresh(return_carries=True)`` -> ``cont(..., max_iter2,
    *outs[2:])`` — bit-exact vs the uninterrupted solve, with the
    global bias-correction clock continued and stopped solves staying
    stopped. ``resume`` and ``warm_start`` are mutually exclusive.
    """
    from .solvers.common import separable_blocks

    # same separability gate as the nmf() engine dispatch: the kernel
    # applies the prox per pixel tile, so a non-separable prox would
    # silently serialize a wrong solver
    prox_pair = (prox_A, prox_S)
    has = tuple(pj is not None for pj in prox_pair)
    sep = separable_blocks(prox_pair, has, "auto")
    if not all(s or not h for s, h in zip(sep, has)):
        raise ValueError(
            "export_nmf_adaprox_solver needs separable proxs (the "
            "in-kernel scaled prox is applied per pixel tile); use "
            "export_adaprox_solver for sub-iteration prox semantics"
        )
    if prox_A is None:
        prox_A = operators.prox_id
    if prox_S is None:
        prox_S = operators.prox_id
    elif prox_S is operators.prox_plus:
        prox_S = None  # kernel builtin
    resume = bool(resume)
    weighted = bool(weighted)
    if resume and warm_start:
        raise ValueError(
            "resume= (exact continuation) and warm_start= (reference "
            "M=/V= clock-restart semantics) are mutually exclusive"
        )
    if return_carries is None:
        return_carries = resume
    mdt = jnp.dtype(moment_dtype) if moment_dtype else jnp.dtype(jnp.float32)
    run_full = _make_fused_adaprox_runner(
        prox_A, prox_S, float(e_rel), pixel_tile(int(K), int(N), tile_n),
        int(C), int(K),
        int(N), jnp.dtype(dtype), float(b1), float(b2), float(eps),
        moment_dtype=jnp.dtype(moment_dtype) if moment_dtype else None,
        warm=bool(warm_start) or resume, weighted=weighted,
        store_dtype=jnp.dtype(store_dtype) if store_dtype else None,
    )

    def run(A, S, Y, *rest):
        if weighted:
            W, max_iter, *rargs = rest
            data = (A, S, Y, W, max_iter)
        else:
            max_iter, *rargs = rest
            data = (A, S, Y, max_iter)
        kw = {}
        it0 = jnp.int32(0)
        if resume:
            it0, cA0, cS0, loss0, MA, VA, MS, VS, rowsum0 = rargs
            it0 = jnp.asarray(it0, jnp.int32)
            div0 = jnp.logical_and(
                it0 > 0, jnp.logical_not(jnp.isfinite(loss0)))
            data = data + (MA, VA, MS, VS)  # warm moment extras
            # loss0 rides into the loop init so a no-op link outputs
            # its real loss and the chain survives zero-budget links
            kw = dict(it0=it0, conv_A0=cA0, conv_S0=cS0, div0=div0,
                      loss0=loss0, rowsum0=rowsum0[:, None])
        elif rargs:
            data = data + tuple(rargs)  # warm_start moments
        outs = run_full(*data, **kw)
        # the runner's clock is local; report the global one
        head = (outs[0], outs[1], outs[2] + it0) + tuple(outs[3:10])
        return head + ((outs[10][:, 0],) if return_carries else ())

    f32 = jnp.dtype(jnp.float32)
    args = [
        jax.ShapeDtypeStruct((C, K), dtype),
        jax.ShapeDtypeStruct((K, N), dtype),
        jax.ShapeDtypeStruct((C, N), dtype),
    ]
    if weighted:
        args.append(jax.ShapeDtypeStruct((C, N), dtype))
    args.append(jax.ShapeDtypeStruct((), jnp.int32))
    if warm_start or resume:
        if resume:
            args += [jax.ShapeDtypeStruct((), jnp.int32),  # it0
                     jax.ShapeDtypeStruct((), jnp.bool_),  # conv_A0
                     jax.ShapeDtypeStruct((), jnp.bool_),  # conv_S0
                     jax.ShapeDtypeStruct((), f32)]        # loss0
        args += [
            jax.ShapeDtypeStruct((C, K), jnp.float32),
            jax.ShapeDtypeStruct((C, K), jnp.float32),
            jax.ShapeDtypeStruct((K, N), mdt),
            jax.ShapeDtypeStruct((K, N), mdt),
        ]
        if resume:
            args.append(jax.ShapeDtypeStruct((K,), f32))   # rowsum
    return jax_export.export(jax.jit(run), disabled_checks=[_TRITON_CALL])(
        *args).serialize()


@with_matmul_precision
def export_nmf_pgm_sharded(mesh, C, K, N, prox_A=operators.prox_plus,
                           prox_S=operators.prox_plus, e_rel=1e-3,
                           weighted=False, step_stride=None,
                           step_adapt=False, data_axis="data",
                           model_axis=None, dtype=jnp.float32,
                           resume=False, platforms=None):
    """Serialize the explicit-collective sharded whole-solve
    (:func:`proxmin_tpu.parallel.nmf_pgm_sharded`'s computation) as a
    multi-chip serving artifact.

    The artifact embeds the full ``shard_map`` while-loop — pinned
    collective layout included (one (C,K) ``psum`` per iteration plus
    scalar convergence reductions; see ``tests/test_collective_layout``)
    — for a fixed mesh TOPOLOGY: shape, axis names, and the factor
    layout ``A:(model,·) S:(·,data) Y/W:(model,data)``. Loading requires
    a mesh with the same device count (device *identities* may differ —
    a restarted host serves the same artifact).

    Executable signature ``(A, S, Y, max_iter) -> (A', S', it, conv_A,
    conv_S, loss)`` — weighted inserts ``W: (C,N)`` after ``Y``
    (:func:`export_nmf_solver` ordering). ``max_iter`` is a runtime
    (replicated i32) argument: one artifact serves any iteration
    budget. Inputs must be committed to the serving mesh with the
    layout above (``parallel.shard_nmf_problem`` does this).

    ``step_stride``/``step_adapt`` bake the segmented strided Lipschitz
    refresh (warm-started sharded power iteration) exactly as in
    ``nmf_pgm_sharded``. ``platforms`` (e.g. ``("cuda", "cpu")``) lowers
    a multi-platform artifact — the sharded solve contains no
    platform-specific custom calls (its spectral bounds are power
    iterations, not LAPACK), so cross-platform export is safe; default
    is the current backend, matching the other export functions.

    ``resume=True`` exports the exact-warm-restart variant for
    preempted multi-device solves: the signature appends the carried scalars
    after ``max_iter`` — ``it0: i32, conv_A: bool, conv_S: bool,
    loss: dtype`` always (the terminal flags keep a solve that already
    stopped — converged, or diverged with a nan-poisoned loss —
    stopped on resume); strided configurations add ``(step_A, step_S,
    stride: i32, seg_end: i32)`` and weighted strided ones a ``v:
    (N, K)`` pixel-sharded power iterate. Those carries are exactly
    the artifact OUTPUTS from position 2 on (``it, conv_A, conv_S,
    loss`` then the strided carries), so a continuation feeds
    ``outs[2:]`` from any artifact's outputs — or a live solve's
    ``.state`` (or its ``proxmin_tpu.checkpoint`` restore) — and
    reproduces the uninterrupted trajectory exactly. ``max_iter``
    counts the additional iterations, like
    ``nmf_pgm_sharded(state=...)``.
    """
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from .parallel.sharding import _build_pgm_solve

    if prox_A is None:
        prox_A = operators.prox_id
    if prox_S is None:
        prox_S = operators.prox_id
    weighted = bool(weighted)
    resume = bool(resume)
    strided = (step_stride is not None and step_stride > 1) or step_adapt

    def run(A, S, Y, *rest):
        # max_iter (and the resume carries) ride after Y/W. The traced
        # scalars close into the shard_map body (replicated), so the
        # artifact takes the iteration budget at call time.
        if weighted:
            W, max_iter, *rargs = rest
        else:
            max_iter, *rargs = rest
            W = Y  # dead argument on the unweighted path (D = R)
        solve = _build_pgm_solve(
            mesh, weighted, prox_A, prox_S, float(e_rel), max_iter,
            data_axis, model_axis, step_stride, bool(step_adapt),
            resume=resume,
        )
        outs = solve(A, S, Y, W, *rargs)
        # strided and resume artifacts return the carries, so a later
        # continuation can start from ANY artifact's outputs (not only
        # from a live solve's checkpoint); unstrided fresh artifacts
        # keep the minimal 6-output signature (their only carry, the
        # clock, is output #3)
        return outs if (resume or strided) else outs[:6]

    def sds(shape, spec, dt=dtype):
        return jax.ShapeDtypeStruct(
            shape, dt, sharding=NamedSharding(mesh, spec))

    args = [
        sds((C, K), P(model_axis, None)),
        sds((K, N), P(None, data_axis)),
        sds((C, N), P(model_axis, data_axis)),
    ]
    if weighted:
        args.append(sds((C, N), P(model_axis, data_axis)))
    args.append(sds((), P(), jnp.int32))
    if resume:
        args.append(sds((), P(), jnp.int32))          # it0
        args.append(sds((), P(), jnp.bool_))          # conv_A
        args.append(sds((), P(), jnp.bool_))          # conv_S
        args.append(sds((), P()))                     # loss
        if strided:
            args += [sds((), P()), sds((), P()),      # step_A, step_S
                     sds((), P(), jnp.int32),         # stride
                     sds((), P(), jnp.int32)]         # seg_end
            if weighted:
                args.append(sds((N, K), P(data_axis, None)))  # v
    kwargs = {"platforms": tuple(platforms)} if platforms else {}
    return jax_export.export(jax.jit(run), **kwargs)(*args).serialize()


@with_matmul_precision
def export_nmf_adaprox_sharded(mesh, C, K, N, prox_A=operators.prox_plus,
                               prox_S=operators.prox_plus, scheme="adam",
                               b1=0.9, b2=0.999, eps=1e-8, p=0.25,
                               e_rel=1e-3, weighted=False,
                               warm_start=False, prox_max_iter=1000,
                               data_axis="data", model_axis=None,
                               dtype=jnp.float32, platforms=None):
    """Serialize a SHARDED proximal-Adam NMF solve as a multi-chip
    serving artifact (the adaprox sibling of
    :func:`export_nmf_pgm_sharded`).

    Uses the XLA driver's own body/init/cond builders under auto-SPMD
    partitioning — the collective layout this produces is the one the
    audit pins (``tests/test_collective_layout.py``: per-iteration
    (C,K) all-reduces, no all-gather of pixel-sharded operands). Any of
    the six Φ/Ψ schemes; prox sub-iterations run in-kernel with the
    driver's semantics (bounded by ``prox_max_iter``).

    Signature ``(A, S, Y[, W], max_iter) -> (A', S', M_A, V_A, Vhat_A,
    M_S, V_S, Vhat_S, it, conv_A, conv_S, diverged)``; ``max_iter`` is
    a runtime replicated i32 (which is why ``b1`` must be a constant,
    not a per-iteration schedule — use :func:`export_adaprox_solver`
    for schedules). ``warm_start=True`` appends
    ``(M_A, V_A, Vhat_A, M_S, V_S, Vhat_S, it0, conv_A0, conv_S0,
    diverged0)`` inputs accepting a previous artifact's returned
    moments plus the global bias-correction clock and terminal flags
    (outputs 2..7 then 8..11 feed straight back in) — the continuation
    walks the exact uninterrupted trajectory (the driver's ``state=``
    semantics, not the reference's clock-restarting ``M=/V=`` warm
    start), and a solve that already stopped stays stopped.
    """
    from functools import partial

    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from .nmf import grad_likelihood, step_adaprox
    from .solvers.adaprox import (
        SCHEMES, _make_adaprox_body, init_adaprox_state, make_adaprox_cond,
        normalize_b1_schedule,
    )
    from .solvers.common import normalize_per_block, normalize_prox
    from .utils import make_stepper

    if hasattr(b1, "__iter__"):
        raise ValueError(
            "export_nmf_adaprox_sharded takes a constant b1 (max_iter is "
            "a runtime argument, so a per-iteration schedule has no "
            "static length); use export_adaprox_solver for b1 schedules"
        )
    n = 2
    prox_in = (prox_A, prox_S)
    has_prox = tuple(pj is not None for pj in prox_in)
    prox_t = normalize_prox(prox_in, n)
    e_rel_t = normalize_per_block(e_rel, n)
    # constant schedule as a (1,) array: the body's b1[it] gather clamps
    # every index to 0 (JAX out-of-bounds gather semantics), so one
    # entry serves any runtime iteration count — exactness vs the live
    # driver is pinned by tests/test_sharding.py
    b1s = normalize_b1_schedule(b1, 1)
    phi_psi = SCHEMES[scheme.lower()]
    stepper = make_stepper(step_adaprox, n)
    weighted = bool(weighted)

    def run(A, S, Y, *rest):
        if weighted:
            W, max_iter, *wargs = rest
        else:
            max_iter, *wargs = rest
            W = 1
        grad = partial(grad_likelihood, Y=Y, W=W)
        body = _make_adaprox_body(grad, stepper, prox_t, has_prox,
                                  phi_psi, b1s, b2, eps, p, e_rel_t,
                                  True, prox_max_iter)
        x0 = (A, S)
        if warm_start:
            M_A, V_A, Vh_A, M_S, V_S, Vh_S, it0, cA0, cS0, dv0 = wargs
            M0, V0 = (M_A, M_S), (V_A, V_S)
            Vhat0 = (Vh_A, Vh_S)
            rflags = (jnp.stack([jnp.asarray(cA0, bool),
                                 jnp.asarray(cS0, bool)]),
                      jnp.asarray(dv0, bool))
        else:
            M0 = V0 = Vhat0 = tuple(jnp.zeros_like(x) for x in x0)
            it0 = None
            rflags = None
        state = init_adaprox_state(x0, M0, V0, Vhat0, stepper, grad, n,
                                   max_iter, trace=False, it0=it0,
                                   resume_flags=rflags)
        cond = make_adaprox_cond(True, max_iter)
        st = jax.lax.while_loop(cond, body, state)
        return (st.x[0], st.x[1], st.M[0], st.V[0], st.Vhat[0],
                st.M[1], st.V[1], st.Vhat[1], st.it + st.it0,
                st.converged[0], st.converged[1], st.diverged)

    def sds(shape, spec, dt=dtype):
        return jax.ShapeDtypeStruct(
            shape, dt, sharding=NamedSharding(mesh, spec))

    a_spec, s_spec = P(model_axis, None), P(None, data_axis)
    args = [sds((C, K), a_spec), sds((K, N), s_spec),
            sds((C, N), P(model_axis, data_axis))]
    if weighted:
        args.append(sds((C, N), P(model_axis, data_axis)))
    args.append(sds((), P(), jnp.int32))
    if warm_start:
        args += [sds((C, K), a_spec)] * 3 + [sds((K, N), s_spec)] * 3
        args.append(sds((), P(), jnp.int32))          # it0
        args.append(sds((), P(), jnp.bool_))          # conv_A0
        args.append(sds((), P(), jnp.bool_))          # conv_S0
        args.append(sds((), P(), jnp.bool_))          # diverged0
    kwargs = {"platforms": tuple(platforms)} if platforms else {}
    return jax_export.export(jax.jit(run), **kwargs)(*args).serialize()


def load_solver(blob):
    """Deserialize an exported solver into a callable.

    Works for any of the export functions in this module: the returned
    callable forwards its arguments to the embedded executable (Python
    ints are converted to i32 scalars, e.g. the NMF artifact's
    ``max_iter``; Python bools to bool scalars, e.g. the resume
    artifacts' terminal flags — bool is an int subtype, so the order
    of these checks matters)."""
    exported = jax_export.deserialize(blob)

    def solve(*args):
        args = tuple(
            jnp.asarray(a) if isinstance(a, bool)
            else jnp.int32(a) if isinstance(a, int) else a
            for a in args
        )
        return exported.call(*args)

    return solve


def save_exported(path, blob):
    with open(path, "wb") as fh:
        fh.write(blob)
    return path


def load_exported(path):
    with open(path, "rb") as fh:
        return load_solver(fh.read())
