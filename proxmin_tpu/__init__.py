"""proxmin_tpu — accelerator-native proximal-splitting framework.

A ground-up JAX/XLA re-design with the capabilities of the reference
``proxmin`` package (proximal splitting algorithms for constrained, possibly
non-convex optimization, plus constrained matrix factorization): solvers are
jit-compiled ``lax.while_loop`` drivers with on-device convergence tests,
proximal operators are pure functions (with fused Pallas kernels for the
NMF hot path on CUDA GPUs), and the NMF/CMF application layer shards its
pixel axis over a ``jax.sharding.Mesh`` with XLA collectives for the
factor-gradient reductions.

Top-level surface mirrors the reference (``proxmin/__init__.py``): solvers
and operators are re-exported flat; ``nmf`` and ``utils`` are submodules.
"""

import os as _os

import jax as _jax

# Persistent XLA compilation cache. Solver drivers are closure-configured
# jits, so repeated solves re-lower; caching the compiled executables makes
# later processes cheap. ``JAX_COMPILATION_CACHE_DIR`` (read by JAX itself)
# wins; otherwise the cache lives at a fixed path inside the checkout, so it
# is found again from one process to the next.
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")
if _jax.config.jax_compilation_cache_dir is None:
    _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from .algorithms import *  # noqa: F401,F403
from .operators import *  # noqa: F401,F403
from . import nmf  # noqa: F401
from . import utils  # noqa: F401
from . import operators  # noqa: F401
from . import algorithms  # noqa: F401
from . import linop  # noqa: F401
from . import special  # noqa: F401
from . import checkpoint  # noqa: F401
from . import export  # noqa: F401
from . import functional  # noqa: F401
from .utils import set_matmul_precision  # noqa: F401

__version__ = "0.1.0"


def clear_caches():
    """Drop all cached solver drivers (and jax's own caches).

    Solver drivers are cached by callable identity — the standard
    ``jax.jit`` contract. If your ``grad``/``prox``/``step`` callables
    close over NumPy arrays that you mutate in place between solves,
    either rebuild the callables (fresh identity) or call this.
    """
    from .solvers.pgm import _PGM_CACHE
    from .solvers.adaprox import _ADAPROX_CACHE
    from .solvers.admm import _ADMM_CACHE
    from .solvers.bsdmm import _BSDMM_CACHE
    from .solvers.common import _ASARRAY_CACHE
    from .nmf import (
        _make_fused_adaprox_runner,
        _make_fused_pgm_runner,
        _make_fused_weighted_pgm_runner,
    )

    _PGM_CACHE._d.clear()
    _ADAPROX_CACHE._d.clear()
    _ADMM_CACHE._d.clear()
    _BSDMM_CACHE._d.clear()
    _ASARRAY_CACHE._d.clear()
    _make_fused_pgm_runner.cache_clear()
    _make_fused_weighted_pgm_runner.cache_clear()
    _make_fused_adaprox_runner.cache_clear()
    _jax.clear_caches()
