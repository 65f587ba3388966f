"""Multi-device execution: mesh construction, problem sharding, and the
explicitly-collective NMF training step.

The scale axis of this problem domain is the pixel axis N of the data
matrix Y (C×N); sharding it across a ``jax.sharding.Mesh`` is the analogue
of data/sequence parallelism (SURVEY.md §5). The tiny A factor (C×K)
replicates (or shards its channel axis over an optional 'model' axis —
tensor parallelism for many-channel problems); per-factor gradient
reductions are ``psum`` collectives.
"""

from .sharding import (  # noqa: F401
    hlo_collectives,
    make_mesh,
    shard_nmf_problem,
    make_nmf_pgm_step,
    nmf_adaprox_sharded,
    nmf_pgm_sharded,
    prox_unity_sharded,
)
from .distributed import (  # noqa: F401
    DistributedInfo,
    initialize_distributed,
)

__all__ = [
    "make_mesh",
    "shard_nmf_problem",
    "make_nmf_pgm_step",
    "nmf_adaprox_sharded",
    "nmf_pgm_sharded",
    "prox_unity_sharded",
    "initialize_distributed",
    "DistributedInfo",
    "hlo_collectives",
]
