"""Fused NMF iteration kernels (Pallas through Triton, for NVIDIA GPUs).

The XLA path for one NMF iteration materializes the residual
``D = W * (A S - Y)`` (C×N) and the gradient ``A^T D`` (K×N) in device
memory and reads them back for the factor gradients, the prox and the
``S S^T`` Gram (reference math: ``nmf.py:39-41``). At small C·K the
iteration is purely bandwidth-bound, so those round trips are the waste.

The kernels here make one pass over the pixel data per iteration: each
program owns one tile of pixel columns, reads its S (and moments), Y and W
columns once, writes the new S (and moments) once, and keeps R, D and the
gradient in registers. Layout:

* a 1-D parallel grid over pixel tiles of a power-of-two width; the arrays
  stay unpadded in device memory, and loads and stores are masked at the
  last tile and at the factor rows beyond K;
* the K-axis products are exact f32 multiply-adds over the (K, tile)
  block — no tensor cores, no TF32;
* every cross-pixel sum (``D S^T``, the Gram, the loss and the convergence
  statistics) is written per tile to a ``(num_tiles, ...)`` output and
  added up by a ``jnp.sum`` after the kernel: blocks run in parallel and in
  no order, so nothing is carried from one program to the next.

Compiled kernels need a CUDA GPU. Pallas's interpreter runs them anywhere
when asked (``interpret=True``, or :data:`INTERPRET` for whole solves);
a compiled call on any other backend raises.
"""

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["fused_nmf_pgm_step", "fused_nmf_adaprox_step", "pixel_tile",
           "cuda_available"]

#: Run the kernels in Pallas's interpreter when a call does not say. The
#: test suite turns this on for CPU runs; nothing else should.
INTERPRET = False

#: Unrolling the channel loop lets the compiler overlap the channel loads;
#: past this many channels the loop stays a loop so the kernel body (and
#: its compile time) does not grow with C.
_UNROLL_MAX_C = 16

#: Two programs for each of an H100's 132 SMs: pixel tiles shrink (down to
#: _MIN_TILE) until the grid has at least this many programs.
_MIN_PROGRAMS = 264
_MIN_TILE = 128
_MAX_TILE = 2048
#: Values of each (K, tile) f32 block one program holds, at 4 warps: 32
#: per thread keeps S, the gradient and the new S in registers.
_BLOCK_VALUES = 4096
_NUM_WARPS = 4


def cuda_available():
    """True when JAX's default backend is a CUDA GPU."""
    try:
        dev = jax.devices()[0]
    except RuntimeError:
        return False
    return (dev.platform == "gpu"
            and "rocm" not in str(dev.client.platform_version).lower())


def _resolve_interpret(interpret):
    if interpret is None:
        interpret = INTERPRET
    if not interpret and not cuda_available():
        raise RuntimeError(
            "the fused NMF kernels compile only for a CUDA GPU (default "
            f"backend here: {jax.default_backend()!r}); use engine='xla', "
            "or interpret=True to run them in Pallas's interpreter"
        )
    return bool(interpret)


def pixel_tile(K, N, tile_n=None):
    """Pixel-tile width of the fused kernels for a (K, N) factor.

    ``tile_n`` (a power of two) overrides the rule. Otherwise: the widest
    power of two with about :data:`_BLOCK_VALUES` values in a (K, tile)
    block, shrunk until the grid has :data:`_MIN_PROGRAMS` programs."""
    if tile_n is not None:
        tile_n = int(tile_n)
        if tile_n < 16 or tile_n & (tile_n - 1):
            raise ValueError(
                f"tile_n must be a power of two >= 16, got {tile_n}")
        return tile_n
    kp = pl.next_power_of_2(K)
    tile = max(_MIN_TILE, min(_MAX_TILE, _BLOCK_VALUES // kp))
    while tile > _MIN_TILE and pl.cdiv(N, tile) < _MIN_PROGRAMS:
        tile //= 2
    return tile


def _channel_loop(C, body, carry):
    """``for c in range(C): carry = body(c, carry)`` — unrolled for few
    channels, a device loop for many."""
    if C <= _UNROLL_MAX_C:
        for c in range(C):
            carry = body(c, carry)
        return carry
    return lax.fori_loop(0, C, body, carry)


def _tile_indices(K, N, tile):
    """Row/column indices and masks of this program's (kp, tile) block."""
    j = pl.program_id(0)
    kk = jnp.arange(pl.next_power_of_2(K))
    cols = j * tile + jnp.arange(tile)
    kmask = kk < K
    nmask = cols < N
    return j, kk, cols, kmask, nmask, kmask[:, None] & nmask[None, :]


def _load_rows(ref, rows, cols, mask):
    return plgpu.load(ref.at[rows[:, None], cols[None, :]], mask=mask,
                      other=0.0).astype(jnp.float32)


def _residual_pass(A_ref, Y_ref, W_ref, gA_ref, S, store_dtype, j, kk, cols,
                   kmask, nmask, C):
    """Stream the channels of one tile: per channel c the residual row
    ``r = A[c] S - Y[c]``, ``d = W[c] r``; writes this tile's ``D S^T`` rows
    to ``gA_ref[j]`` and returns ``(A^T D, sum_c d r)`` for the tile.

    The residual product takes A rounded to S's storage dtype, so a
    reduced-precision store (``store_dtype``) multiplies two stored-type
    operands — the engines' store semantics (a no-op for f32)."""

    def channel(c, carry):
        gS, loss = carry
        a = plgpu.load(A_ref.at[c, kk], mask=kmask, other=0.0)
        y = plgpu.load(Y_ref.at[c, cols], mask=nmask,
                       other=0.0).astype(jnp.float32)
        a_res = a.astype(store_dtype).astype(jnp.float32)
        r = jnp.sum(a_res[:, None] * S, axis=0) - y
        if W_ref is None:
            d = r
        else:
            d = plgpu.load(W_ref.at[c, cols], mask=nmask,
                           other=0.0).astype(jnp.float32) * r
        plgpu.store(gA_ref.at[j, c, kk], jnp.sum(S * d[None, :], axis=1),
                    mask=kmask)
        return gS + a[:, None] * d[None, :], loss + d * r

    return _channel_loop(C, channel, (jnp.zeros_like(S),
                                      jnp.zeros(S.shape[1:], S.dtype)))


def _store_stats(stats_ref, j, loss, S_old, S_new):
    dS = S_new - S_old
    stats_ref[j, 0] = jnp.sum(loss) / 2
    stats_ref[j, 1] = jnp.sum(dS * dS)
    stats_ref[j, 2] = jnp.sum(S_new * S_new)


def _pgm_step_kernel(sS_ref, A_ref, S_ref, Y_ref, *refs, C, K, N, tile,
                     weighted, prox_S):
    """One PGM iteration's S-side work on one pixel tile:

        R        = A S - Y, D = W R (or R)    (registers only)
        gA[j]    = D S^T                       (OLD S — Jacobi block update,
                                                reference pgm semantics
                                                algorithms.py:105-108)
        S_new    = prox_S(S - sS A^T D, sS)
        SSt[j]   = S_new S_new^T               (the NEXT iteration's
                                                Lipschitz input — exact,
                                                not lagged)
        stats[j] = [loss, ||S_new - S||^2, ||S_new||^2]
    """
    if weighted:
        W_ref, gA_ref, Snew_ref, SSt_ref, stats_ref = refs
    else:
        W_ref = None
        gA_ref, Snew_ref, SSt_ref, stats_ref = refs
    j, kk, cols, kmask, nmask, mask = _tile_indices(K, N, tile)
    sS = sS_ref[0]

    S = _load_rows(S_ref, kk, cols, mask)
    gS, loss = _residual_pass(A_ref, Y_ref, W_ref, gA_ref, S, S_ref.dtype,
                              j, kk, cols, kmask, nmask, C)
    X = S - sS * gS
    S_new = jnp.maximum(X, 0.0) if prox_S is None else prox_S(X, sS)
    # rows >= K and columns >= N are outside the problem: keep them zero
    # so an arbitrary prox cannot leak into the sums below
    S_new = jnp.where(mask, S_new, 0.0)
    S_stored = S_new.astype(Snew_ref.dtype)
    plgpu.store(Snew_ref.at[kk[:, None], cols[None, :]], S_stored, mask=mask)
    # the Gram feeding the next Lipschitz step uses the values that will
    # actually be read back (post-rounding), so the recursion stays
    # self-consistent under bf16 storage
    S_next = S_stored.astype(jnp.float32)
    for k in range(K):
        row = jnp.sum(jnp.where(kk[:, None] == k, S_next, 0.0), axis=0)
        plgpu.store(SSt_ref.at[j, k, kk],
                    jnp.sum(S_next * row[None, :], axis=1), mask=kmask)
    _store_stats(stats_ref, j, loss, S, S_next)


def _pallas(kernel, num_tiles, out_shape, interpret, name):
    return pl.pallas_call(
        kernel,
        grid=(num_tiles,),
        out_shape=out_shape,
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS),
        interpret=interpret,
        name=name,
    )


def fused_nmf_pgm_step(A, S, Y, sS, W=None, prox_S=None, tile_n=None,
                       interpret=None):
    """Single fused PGM-NMF iteration (S-side) — one pass over the pixels.

    Any shapes ``A (C, K)``, ``S (K, N)``, ``Y``/``W (C, N)``; S/Y/W may be
    stored bfloat16 (compute is f32). Returns
    ``(gA, S_new, SSt_new, loss, dS_sq, nS_sq)``:

    * ``gA``: gradient of the A factor at the (old) iterate — the caller
      applies ``A_new = prox_A(A - sA * gA, sA)`` (a tiny C×K op);
    * ``S_new``: the proxed S update with step ``sS``;
    * ``SSt_new = S_new S_new^T``: the exact Gram the *next* iteration
      needs for its Lipschitz step — so the PGM recursion stays exact
      while doing one pass per iteration;
    * ``loss`` at the old iterate, and the fixed-point convergence
      statistics ``||S_new - S||^2`` / ``||S_new||^2``.

    ``prox_S(x, step)`` receives a (K', tile) block (K' = K rounded up to a
    power of two; the extra rows are discarded) and must be jittable and
    elementwise or factor-axis-local: anything normalizing along the pixel
    axis needs the sharded path. Default: non-negativity.
    """
    interpret = _resolve_interpret(interpret)
    C, K = A.shape
    N = S.shape[1]
    tile = pixel_tile(K, N, tile_n)
    T = pl.cdiv(N, tile)
    weighted = W is not None
    kernel = functools.partial(
        _pgm_step_kernel, C=C, K=K, N=N, tile=tile, weighted=weighted,
        prox_S=prox_S)
    f32 = jnp.float32
    out_shape = [
        jax.ShapeDtypeStruct((T, C, K), f32),
        jax.ShapeDtypeStruct((K, N), S.dtype),
        jax.ShapeDtypeStruct((T, K, K), f32),
        jax.ShapeDtypeStruct((T, 3), f32),
    ]
    inputs = [jnp.reshape(jnp.asarray(sS, f32), (1,)),
              A.astype(f32), S, Y] + ([W] if weighted else [])
    gA, S_new, SSt, stats = _pallas(kernel, T, out_shape, interpret,
                                    "nmf_pgm_step")(*inputs)
    stats = jnp.sum(stats, axis=0)
    return (jnp.sum(gA, axis=0), S_new, jnp.sum(SSt, axis=0),
            stats[0], stats[1], stats[2])


def _adaprox_step_kernel(sc_ref, alpha_ref, A_ref, S_ref, M_ref, V_ref,
                         Y_ref, *refs, C, K, N, tile, weighted, prox_S, b2,
                         eps):
    """One proximal-Adam (``scheme='adam'``) iteration's S-side work on one
    pixel tile:

        R      = A S - Y, D = W R (or R)      (registers only)
        gS     = A^T D
        M'     = (1 - b1_t) gS + b1_t M       (EMA moments — reference
        V'     = (1 - b2) gS^2 + b2 V          algorithms.py:147-160)
        Phi    = M' / (1 - b1_t^t)
        Psi    = sqrt(V' / (1 - b2^t)) + eps
        S1     = prox_S(S - alpha_S Phi/Psi, alpha_S/Psi)   (separable
                 closed-form scaled prox — exact, adaprox.py:271-281)
        gA[j]  = D S^T                        (OLD S — Jacobi blocks,
                                               reference algorithms.py:374)
        rowsum[j] = sum_n S1                  (feeds the NEXT iteration's
                                               step_adaprox mean/10 step)
        stats[j]  = [loss, ||S1 - S||^2, ||S1||^2]

    S, M and V are read and written once; bf16-stored moments are cast in
    registers.
    """
    if weighted:
        W_ref, gA_ref, Snew_ref, Mnew_ref, Vnew_ref, rowsum_ref, \
            stats_ref = refs
    else:
        W_ref = None
        gA_ref, Snew_ref, Mnew_ref, Vnew_ref, rowsum_ref, stats_ref = refs
    j, kk, cols, kmask, nmask, mask = _tile_indices(K, N, tile)
    b1_t = sc_ref[0]    # b1 at this iteration (schedule value)
    bc1 = sc_ref[1]     # 1 / (1 - b1_t^t)
    bc2 = sc_ref[2]     # 1 / (1 - b2^t)
    alpha = plgpu.load(alpha_ref.at[kk], mask=kmask, other=0.0)[:, None]

    S = _load_rows(S_ref, kk, cols, mask)
    gS, loss = _residual_pass(A_ref, Y_ref, W_ref, gA_ref, S, S_ref.dtype,
                              j, kk, cols, kmask, nmask, C)
    M1 = (1.0 - b1_t) * gS + b1_t * _load_rows(M_ref, kk, cols, mask)
    V1 = (1.0 - b2) * (gS * gS) + b2 * _load_rows(V_ref, kk, cols, mask)
    Psi = jnp.maximum(jnp.sqrt(V1 * bc2) + eps, jnp.finfo(jnp.float32).tiny)
    S1 = S - alpha * (M1 * bc1 / Psi)
    S1 = jnp.maximum(S1, 0.0) if prox_S is None else prox_S(S1, alpha / Psi)
    S1 = jnp.where(mask, S1, 0.0)

    S1_stored = S1.astype(Snew_ref.dtype)
    block = (kk[:, None], cols[None, :])
    plgpu.store(Snew_ref.at[block], S1_stored, mask=mask)
    plgpu.store(Mnew_ref.at[block], M1.astype(Mnew_ref.dtype), mask=mask)
    plgpu.store(Vnew_ref.at[block], V1.astype(Vnew_ref.dtype), mask=mask)
    # downstream statistics use the values that will actually be read
    # back (post-rounding) — same rule as the PGM kernel's Gram
    S1_next = S1_stored.astype(jnp.float32)
    plgpu.store(rowsum_ref.at[j, kk], jnp.sum(S1_next, axis=1), mask=kmask)
    _store_stats(stats_ref, j, loss, S, S1_next)


def fused_nmf_adaprox_step(A, S, M, V, Y, alpha_S, scalars, W=None,
                           prox_S=None, b2=0.999, eps=1e-8, tile_n=None,
                           interpret=None):
    """Single fused proximal-Adam NMF iteration (S-side) — one pass.

    ``alpha_S`` is the per-row step ``(K,)``; ``scalars = (b1_t,
    1/(1-b1_t^t), 1/(1-b2^t))`` as a float32 ``(3,)`` array (computed by
    the caller per iteration, keeping powers of traced scalars out of the
    kernel). ``M``/``V`` may be stored bfloat16 (``moment_dtype``), S/Y/W
    likewise (``store_dtype``): compute is f32 in registers either way.
    Returns ``(gA, S_new, M_new, V_new, rowsum_S1, loss, dS_sq, nS_sq)``.

    ``prox_S`` must be a separable (elementwise, factor-axis-local) scaled
    prox — the exact closed form of the adaprox sub-iteration limit (see
    ``solvers/adaprox.py:271-281``); default non-negativity.
    """
    interpret = _resolve_interpret(interpret)
    C, K = A.shape
    N = S.shape[1]
    if M.shape != S.shape or V.shape != S.shape:
        raise ValueError("moments must have the shape of S")
    tile = pixel_tile(K, N, tile_n)
    T = pl.cdiv(N, tile)
    weighted = W is not None
    kernel = functools.partial(
        _adaprox_step_kernel, C=C, K=K, N=N, tile=tile, weighted=weighted,
        prox_S=prox_S, b2=float(b2), eps=float(eps))
    f32 = jnp.float32
    out_shape = [
        jax.ShapeDtypeStruct((T, C, K), f32),
        jax.ShapeDtypeStruct((K, N), S.dtype),
        jax.ShapeDtypeStruct((K, N), M.dtype),
        jax.ShapeDtypeStruct((K, N), V.dtype),
        jax.ShapeDtypeStruct((T, K), f32),
        jax.ShapeDtypeStruct((T, 3), f32),
    ]
    inputs = [jnp.asarray(scalars, f32),
              jnp.reshape(alpha_S, (K,)).astype(f32),
              A.astype(f32), S, M, V, Y] + ([W] if weighted else [])
    gA, S_new, M_new, V_new, rowsum, stats = _pallas(
        kernel, T, out_shape, interpret, "nmf_adaprox_step")(*inputs)
    stats = jnp.sum(stats, axis=0)
    return (jnp.sum(gA, axis=0), S_new, M_new, V_new,
            jnp.sum(rowsum, axis=0), stats[0], stats[1], stats[2])
