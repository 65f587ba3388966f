"""Shared infrastructure for the solver drivers.

All solvers follow the same accelerator-native pattern:

* **state pytree** — every mutable quantity of the reference's Python loop
  (iterate, momenta, duals, slack, iteration counter, convergence flags)
  becomes a field of a NamedTuple carried through ``lax.while_loop``;
* **fused mode** (default, ``callback=None``) — the whole solve is ONE
  jit-compiled ``lax.while_loop`` with on-device convergence tests: zero
  host round trips until the final result fetch;
* **callback mode** — the single-iteration body is jit-compiled and driven
  by a host loop so the reference's ``callback(*X, it=...)`` /
  ``StopIteration`` protocol keeps working (one device sync per iteration,
  documented cost);
* **reference-shaped returns** — results unpack exactly like the reference
  (``converged, G, S = pgm(...)``) while also exposing ``.x``,
  ``.iterations`` etc. as attributes; NumPy array inputs are additionally
  updated in place to preserve the reference's "X will be updated" contract
  (reference mutates user arrays, e.g. ``algorithms.py:107-108``).
"""

import numpy as np
from collections import OrderedDict as _OrderedDict

import jax
import jax.numpy as jnp

from .. import operators
from ..utils import _as_tuple

__all__ = [
    "SolverResult",
    "normalize_prox",
    "normalize_per_block",
    "writeback",
    "zeros_like_shapes",
    "tupleize",
]


class BoolResult(int):
    """A bool-valued result that also carries named attributes.

    The reference ``sdmm`` returns a bare convergence flag
    (``algorithms.py:650``); wrapping it in a tuple would break truthiness
    (``if sdmm(...)`` must be False when not converged), so this subclasses
    int (bool cannot be subclassed) with attribute storage.
    """

    def __new__(cls, value, **attrs):
        obj = super().__new__(cls, bool(value))
        for k, v in attrs.items():
            object.__setattr__(obj, k, v)
        return obj

    def __repr__(self):
        return f"BoolResult({bool(self)}, {self.__dict__})"


class SolverResult(tuple):
    """A tuple that unpacks like the reference return value but also carries
    named attributes (``.x``, ``.iterations``, ...).

    e.g. ``converged, G, S = pgm(...)`` works (reference parity,
    ``algorithms.py:144``) and ``res = pgm(...); res.x`` gives the solution.
    """

    def __new__(cls, fields, **attrs):
        obj = super().__new__(cls, fields)
        for k, v in attrs.items():
            object.__setattr__(obj, k, v)
        return obj

    def __repr__(self):
        inner = ", ".join(f"{k}={v!r}" for k, v in self.__dict__.items())
        return f"{type(self).__name__}({inner})"


def status_from(converged, diverged, logger=None):
    """Shared structured-status rule for every driver/engine: the
    three-way ``"diverged" | "converged" | "max_iter"`` string plus the
    matching warning (divergence outranks non-convergence)."""
    if logger is not None:
        if diverged:
            logger.warning("Solution diverged (non-finite iterate)")
        elif not converged:
            logger.warning("Solution did not converge")
    return ("diverged" if diverged
            else "converged" if converged else "max_iter")


def tupleize(X):
    """``X`` (array or sequence of arrays) -> tuple of jnp arrays, plus the
    info needed to write results back / unwrap single-block problems."""
    was_single = type(X) not in (list, tuple)
    X_seq = _as_tuple(X)
    originals = tuple(X_seq)

    # integer/bool/half iterates promote to the default float dtype:
    # the solvers carry float-promoted step/momentum scalars, so a
    # sub-f32 (or integer) x would change dtype across the while_loop
    # body — an obscure carry-type crash (or silent garbage for ints;
    # the NumPy reference promotes through float ufuncs).
    # Reduced-precision STORAGE is the fused engines'
    # store_dtype/moment_dtype.
    X_dev = tuple(promote_dtype(x) for x in X_seq)
    return X_dev, originals, was_single


def promote_dtype(a, keep=None):
    """Half/integer/bool arrays -> the default float dtype (the same
    rule :func:`tupleize` applies at the solver boundary) — used by the
    application layer so the fused/sharded engine routes get the same
    promotion as the XLA drivers.

    ``keep``: a reduced storage dtype (the engine's ``store_dtype``)
    that an already-matching array may stay in. The fused runners cast
    to it *inside* the jit (a no-op for a matching input); promoting
    here would eagerly materialize the full-width plane as a jit
    argument — at capacity scale that plane alone is the difference
    between fitting HBM and a device OOM (a 16x100e6 bf16 solve's S+Y
    promoted to f32 is 11.9 GB of arguments on a 16 GB chip)."""
    a = jnp.asarray(a)
    if keep is not None and a.dtype == jnp.dtype(keep):
        return a
    if (jnp.issubdtype(a.dtype, jnp.integer)
            or jnp.issubdtype(a.dtype, jnp.bool_)
            or (jnp.issubdtype(a.dtype, jnp.floating)
                and jnp.finfo(a.dtype).bits < 32)):
        a = a.astype(jnp.result_type(float))
    return a


def promote_dtype_host(a, keep=None):
    """Like :func:`promote_dtype`, but host (NumPy) inputs STAY host
    arrays — no default-backend commitment. Used by the sharded path,
    which device_puts straight to mesh shardings (a ``jnp.asarray``
    here would bounce host data through the default backend first, or
    fail when that backend is unavailable), and by ``nmf()``, where
    untouched float NumPy inputs must keep their identity for the
    in-place writeback contract. ``keep`` as in :func:`promote_dtype`."""
    if isinstance(a, jax.Array):
        return promote_dtype(a, keep=keep)
    a = np.asarray(a)
    dt = jnp.dtype(a.dtype)  # jnp predicates know ml_dtypes (bfloat16,
    #                          float8: NumPy kind 'V', invisible to a
    #                          kind-based check)
    if keep is not None and dt == jnp.dtype(keep):
        return a
    if (jnp.issubdtype(dt, jnp.integer)
            or jnp.issubdtype(dt, jnp.bool_)
            or (jnp.issubdtype(dt, jnp.floating)
                and jnp.finfo(dt).bits < 32)):
        a = a.astype(np.dtype(jnp.result_type(float)))
    return a


def writeback(originals, results):
    """Update NumPy inputs in place (reference in-place contract). JAX array
    inputs are immutable; callers use the returned ``.x`` instead."""
    for orig, res in zip(originals, results):
        # same-or-wider float ndarrays only: writing float results into
        # an integer input (promoted by tupleize) or a NARROWER float
        # (f16 input, f32 results) would truncate silently — the
        # returned .x is the full-precision result. A wider original
        # (f64 NumPy input, f32 compute) keeps the reference in-place
        # contract: the upcast write is value-preserving.
        if (isinstance(orig, np.ndarray) and orig.dtype.kind == "f"
                and orig.dtype.itemsize
                >= jnp.dtype(res.dtype).itemsize):
            orig[...] = np.asarray(res)


def normalize_prox(prox, n_blocks):
    """Reference prox normalization (``algorithms.py:55-64``): broadcast a
    single prox over blocks and map ``None`` -> identity."""
    prox = _as_tuple(prox)
    if len(prox) == 1:
        prox = prox * n_blocks
    if len(prox) != n_blocks:
        # the reference raises AssertionError here (algorithms.py:63);
        # explicit raise so `python -O` keeps the check
        raise AssertionError(
            f"got {len(prox)} prox operators for {n_blocks} variable "
            "blocks (pass one per block, or a single prox to broadcast)"
        )
    return tuple(p if p is not None else operators.prox_id for p in prox)


def normalize_per_block(val, n_blocks):
    """Broadcast a scalar per-block parameter (e.g. ``e_rel``) to a tuple."""
    if np.isscalar(val):
        return (float(val),) * n_blocks
    val = tuple(float(v) for v in val)
    assert len(val) == n_blocks
    return val


UNCACHEABLE = object()


def value_key(v):
    """Cache key for a data argument (step value, operator matrix).

    Hashable scalars key by value; ``None`` by None; **immutable** jax
    arrays by identity. Mutable NumPy arrays return :data:`UNCACHEABLE` —
    id-keying them could serve stale compiled traces after in-place
    mutation, so callers must bypass the cache instead (the pre-cache
    behavior: retrace per call, always correct).
    """
    import jax
    import numpy as _np

    if v is None:
        return None
    if isinstance(v, (bool, int, float)):
        return ("v", float(v))
    if isinstance(v, jax.Array):
        return ("id", id(v))
    if isinstance(v, _np.ndarray):
        return UNCACHEABLE
    return ("id", id(v))


def nested_key(obj):
    """value_key/callable_key over (possibly nested) lists and tuples;
    propagates UNCACHEABLE upward."""
    if isinstance(obj, (list, tuple)):
        parts = tuple(nested_key(o) for o in obj)
        if any(p is UNCACHEABLE for p in parts):
            return UNCACHEABLE
        return parts
    if callable(obj):
        return callable_key(obj)
    return value_key(obj)


def cacheable(key):
    """True if no component of the (nested tuple) key is UNCACHEABLE."""
    if key is UNCACHEABLE:
        return False
    if isinstance(key, tuple):
        return all(cacheable(k) for k in key)
    return True


def callable_key(fn):
    """A cache key for a user callable.

    ``functools.partial`` objects are keyed structurally (wrapped function
    plus keys of the bound values) because APIs like ``nmf`` rebuild
    their partials per call; everything else is keyed by identity. Bound
    values go through :func:`nested_key` so scalars key by value,
    immutable jax arrays by identity, and **mutable NumPy arrays make
    the whole key UNCACHEABLE** (id-keying them would serve stale
    compiled traces after in-place mutation — the drivers then bypass
    their cache and retrace, which is always correct). Id-keying is safe
    because the cache entry holds a strong reference to the callable
    (via the compiled closure), so its id cannot be recycled while the
    key is alive — and evicting the entry also evicts the key.
    """
    import functools as _ft

    if isinstance(fn, _ft.partial):
        parts = (
            callable_key(fn.func),
            tuple(nested_key(a) for a in fn.args),
            tuple((k, nested_key(v))
                  for k, v in sorted(fn.keywords.items())),
        )
        if not cacheable(parts):
            return UNCACHEABLE
        return ("partial",) + parts
    return ("id", id(fn))


class DriverCache:
    """Bounded LRU of compiled solver drivers.

    Solvers are configured by user callables (grad/step/prox closures), so
    a fresh ``jax.jit`` per call would re-trace and re-compile every solve.
    Caching the jitted driver keyed by (callable keys, static params,
    input shapes/dtypes) makes repeated solves pay only the device run.
    Entries hold the user callables alive (see :func:`callable_key`).
    """

    def __init__(self, maxsize=32):
        from collections import OrderedDict

        self._d = OrderedDict()
        self.maxsize = maxsize

    def get_or_build(self, key, build):
        if key in self._d:
            self._d.move_to_end(key)
            return self._d[key]
        value = build()
        self._d[key] = value
        if len(self._d) > self.maxsize:
            self._d.popitem(last=False)
        return value


def split_partial_data(fn, min_bytes=1 << 20):
    """Extract large arrays bound in a ``functools.partial`` so drivers
    can pass them as jit ARGUMENTS instead of trace constants.

    Tracing a solver body embeds every closure-captured array into the
    lowered module as a literal constant — compile time then scales
    with the DATA size. ``jax.closure_convert`` cannot help (concrete
    arrays are "known" to partial_eval and stay inline). But the
    project idiom binds data with ``functools.partial`` (e.g. ``nmf``'s
    ``partial(grad_likelihood, Y=Y, W=W)``), whose bound values are
    INSPECTABLE: this helper pulls out the >=1 MiB array leaves and
    returns ``(rebuild, leaves)`` where ``rebuild(leaves)`` recreates an
    equivalent callable — called at trace time with tracers, so the
    data rides as runtime arguments.

    Non-partial callables (hand-written closures) pass through
    unchanged; their captures remain trace constants. Bind large arrays
    with ``functools.partial`` to stay scale-safe.
    """
    import functools
    import jax as _jax
    import numpy as _np

    def is_big(v):
        return (isinstance(v, (_jax.Array, _np.ndarray))
                and getattr(v, "nbytes", 0) >= min_bytes)

    if isinstance(fn, functools.partial):
        args = list(fn.args)
        kw = dict(fn.keywords)
        binders = []
        leaves = []
        for i, a in enumerate(args):
            if is_big(a):
                binders.append(("arg", i))
                leaves.append(jnp.asarray(a))
                args[i] = None
        for k in sorted(kw):
            if is_big(kw[k]):
                binders.append(("kw", k))
                leaves.append(jnp.asarray(kw[k]))
                kw[k] = None
        if not leaves:
            return (lambda lv: fn), ()
        func = fn.func

        def rebuild(lv):
            a2 = list(args)
            k2 = dict(kw)
            for (tag, key), val in zip(binders, lv):
                if tag == "arg":
                    a2[key] = val
                else:
                    k2[key] = val
            return functools.partial(func, *a2, **k2)

        return rebuild, tuple(leaves)
    return (lambda lv: fn), ()


def split_stepper_data(step, stepper, n_blocks):
    """Data-splitting (:func:`split_partial_data`) for the stepper
    protocol: returns ``(stepper_rebuild, leaves)`` where
    ``stepper_rebuild(leaves)`` recreates an equivalent stepper with the
    large partial-bound arrays re-injected as tracers. Shared by the
    pgm and adaprox drivers."""
    from ..utils import FunctionStepper, StridedStepper, make_stepper

    if hasattr(stepper, "split_data"):
        # custom stepper classes (e.g. nmf.WeightedPGMStepper) split
        # their own data so it rides as jit arguments
        return stepper.split_data()
    if isinstance(stepper, StridedStepper):
        rb, lv = split_partial_data(stepper._orig)

        def stepper_rb(leaves, _st=stepper):
            return StridedStepper(rb(leaves), n_blocks, stride=_st.stride,
                                  safety=_st.safety, adapt=_st.adapt,
                                  max_stride=_st.max_stride)

        return stepper_rb, lv
    if isinstance(stepper, FunctionStepper):
        rb, lv = split_partial_data(step)

        def stepper_rb(leaves):
            return make_stepper(rb(leaves), n_blocks)

        return stepper_rb, lv
    return (lambda leaves, _st=stepper: _st), ()


_ASARRAY_CACHE = DriverCache(maxsize=8)
_ASARRAY_BYTE_LIMIT = 64 * 1024 * 1024


def asarray_cached(x):
    """``jnp.asarray`` with a content-keyed device-array cache for host
    inputs.

    A NumPy input converted with plain ``jnp.asarray`` gets a fresh
    device array (new ``id``) on every call, so driver-cache keys built
    from it (e.g. ``nmf``'s ``partial(grad_likelihood, Y=...)``) never
    repeat and every solve re-traces. Keying the converted array by
    *content hash* makes repeat solves with equal data reuse both the
    device array and the compiled driver — and stays mutation-safe:
    in-place mutation changes the hash, yielding a fresh device copy
    (unlike id-keying, which would serve stale data). Inputs larger than
    64 MiB skip the cache (hashing cost ~ tens of ms); pass jax arrays
    for zero-overhead cache hits at scale.
    """
    import numpy as _np

    if isinstance(x, _np.ndarray) and x.nbytes <= _ASARRAY_BYTE_LIMIT:
        key = (x.shape, str(x.dtype), hash(x.tobytes()))
        return _ASARRAY_CACHE.get_or_build(key, lambda: jnp.asarray(x))
    return jnp.asarray(x)


def separable_blocks(prox_in, has_prox, separable_prox):
    """Resolve ``adaprox``'s ``separable_prox`` flag into a per-block
    tuple (shared by the host driver and ``functional``).

    ``True`` asserts every constrained block's prox admits the
    closed-form scaled prox (the caller's responsibility); ``"auto"``
    consults the operator's ``separable_when(bound_kwargs)`` predicate
    (see ``operators.py``), unwrapping one level of
    ``functools.partial``; ``False`` disables. Any other value is an
    error (a typo like ``"Auto"`` silently disabling the optimization
    would be invisible)."""
    import functools as _ft

    n = len(prox_in)
    if separable_prox is True:
        return tuple(has_prox)
    if separable_prox is False or separable_prox is None:
        return (False,) * n
    if separable_prox != "auto":
        raise ValueError(
            f"separable_prox must be True, False or 'auto', "
            f"got {separable_prox!r}"
        )

    def check(pj):
        if pj is None:
            return False
        kw = {}
        if isinstance(pj, _ft.partial):
            kw = dict(pj.keywords)
            pj = pj.func
        pred = getattr(pj, "separable_when", None)
        return bool(pred(kw)) if pred is not None else False

    return tuple(check(pj) for pj in prox_in)


_GRAD_FROM_F = _OrderedDict()
_GRAD_FROM_F_MAXSIZE = 32


def grad_from_f(f, n_blocks):
    """Derive a multi-block gradient from the smooth function itself via
    ``jax.grad`` — the accelerator-native replacement for the reference's
    autograd compatibility (``README.md:33``): users pass ``f`` and the
    solver differentiates it.

    Memoized by ``(id(f), n_blocks)`` (holding ``f`` alive) so the
    derived callable is identity-stable and driver-cache keys repeat
    across solves; LRU-bounded so per-request lambdas (and the data
    they capture) cannot accumulate for the process lifetime."""
    key = (id(f), n_blocks)
    hit = _GRAD_FROM_F.get(key)
    if hit is not None and hit[0] is f:
        _GRAD_FROM_F.move_to_end(key)
        return hit[1]
    g = jax.grad(f, argnums=tuple(range(n_blocks)))
    _GRAD_FROM_F[key] = (f, g)
    while len(_GRAD_FROM_F) > _GRAD_FROM_F_MAXSIZE:
        _GRAD_FROM_F.popitem(last=False)
    return g


def abstract_key(tree):
    """Shapes/dtypes signature of a pytree of arrays."""
    import jax

    return tuple(
        (l.shape, str(l.dtype))
        for l in jax.tree_util.tree_leaves(tree)
    )


def zeros_like_shapes(fn, *args, **kwargs):
    """Zeros pytree matching ``jax.eval_shape(fn, *args)`` — used to build
    while-loop carries for quantities first produced inside the loop body."""
    shapes = jax.eval_shape(fn, *args, **kwargs)
    return jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype), shapes
    )
