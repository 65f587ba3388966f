"""Checkpoint / resume for solver state.

The reference's only continuation mechanism is AdaProx warm start via the
``M``/``V``/``Vhat`` moment arrays plus the caller's own ``X``
(``algorithms.py:262-264,347-359``) — no serialization anywhere. Here every
solver's resumable state is a pytree, so checkpointing is generic:

* :func:`save_checkpoint` / :func:`load_checkpoint` persist any pytree.
  Orbax is used when available (async, multi-host-safe, the accelerator-native
  choice); otherwise a pickle fallback (``.pkl``) keeps the feature
  dependency-free.
* Solver ``.state`` pytrees are NOT plain dicts of arrays: they carry
  string/bool metadata (e.g. the sharded solve's ``kind``) and nested
  tuple structure that resume validation checks exactly
  (``tree_structure`` comparisons in the pgm/adaprox drivers). Both
  stores therefore persist the ARRAY leaves as a flat ``leaf_i`` dict
  (orbax/tensorstore cannot store string leaves at all) and the
  treedef + non-array leaves in a pickled metadata sidecar, so a
  round-trip restores the exact original structure — tuples stay
  tuples, not orbax's lists.
* For AdaProx, ``save_checkpoint(path, x=res.x, M=res.M, V=res.V,
  Vhat=res.Vhat)`` then ``adaprox(ckpt["x"], ..., M=ckpt["M"], ...)``
  resumes exactly like the reference's warm start; exact resume is
  ``save_checkpoint(path, x=res.x, solver_state=res.state)`` then
  ``state=ckpt["solver_state"]``.
"""

import os

import numpy as np
import jax

__all__ = ["save_checkpoint", "load_checkpoint"]

_V2 = "__proxmin_ckpt_v2__"


def _try_orbax():
    try:
        import orbax.checkpoint as ocp
        return ocp
    except Exception:
        return None


def _split(state, keep_jax=False):
    """Flatten a pytree into (flat array dict, static-leaf dict, treedef,
    n_leaves). Array-able leaves go to the array store; string/object
    leaves (which tensorstore rejects) ride with the structure metadata.

    ``keep_jax=True`` (the orbax path) leaves ``jax.Array`` leaves
    as-is: orbax serializes global/sharded arrays natively, so
    multi-host sharded solver states checkpoint without the
    ``np.asarray`` host gather (which would fail outright on
    non-addressable shards). The pickle path always converts to NumPy
    (it is single-host by nature)."""
    leaves, treedef = jax.tree_util.tree_flatten(state)
    arrays, statics = {}, {}
    for i, leaf in enumerate(leaves):
        if keep_jax and isinstance(leaf, jax.Array):
            arrays[f"leaf_{i}"] = leaf
            continue
        a = np.asarray(leaf)
        if a.dtype.kind in "USO":
            statics[i] = leaf
        else:
            arrays[f"leaf_{i}"] = a
    return arrays, statics, treedef, len(leaves)


def _merge(arrays, statics, treedef, n):
    leaves = [statics[i] if i in statics else arrays[f"leaf_{i}"]
              for i in range(n)]
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _meta_path(path):
    return os.path.abspath(path).rstrip("/") + ".meta.pkl"


def save_checkpoint(path, tree=None, *, use_orbax=None, **named):
    """Persist a pytree (or keyword entries) of solver state.

    ``path``: directory (orbax) or file path (pickle fallback; ``.pkl``
    appended if missing). Pass either a single ``tree`` or keyword
    entries; they merge into one dict pytree. Returns the path actually
    written (orbax additionally writes a ``<path>.meta.pkl`` structure
    sidecar next to the directory).
    """
    import pickle

    state = dict(named)
    if tree is not None:
        state["__tree__"] = tree
    if use_orbax is None:
        use_orbax = _try_orbax() is not None
    arrays, statics, treedef, n = _split(state, keep_jax=use_orbax)
    meta = {"statics": statics, "treedef": treedef, "n": n}

    if use_orbax:
        ocp = _try_orbax()
        if ocp is None:
            raise RuntimeError("orbax requested but not importable")
        path = os.path.abspath(path)
        ckptr = ocp.StandardCheckpointer()
        ckptr.save(path, arrays, force=True)
        ckptr.wait_until_finished()
        if jax.process_index() == 0:
            # one writer for the structure sidecar (identical on every
            # process; orbax handles the array store's coordination)
            with open(_meta_path(path), "wb") as fh:
                pickle.dump(meta, fh)
        if jax.process_count() > 1:
            # save returns only when the checkpoint (sidecar included)
            # is durable on every process — otherwise a fast process
            # could race ahead to load before process 0's sidecar lands
            from jax.experimental import multihost_utils

            multihost_utils.sync_global_devices(
                "proxmin_ckpt_save:" + path)
        return path

    if not path.endswith(".pkl"):
        path = path + ".pkl"
    with open(path, "wb") as fh:
        pickle.dump({_V2: True, "arrays": arrays, "meta": meta}, fh)
    return path


def load_checkpoint(path, like=None, *, use_orbax=None):
    """Load a checkpoint saved by :func:`save_checkpoint`.

    Returns the dict pytree with its exact original structure (tuples,
    strings, nested solver states); a bare ``tree`` argument round-trips
    under the ``"__tree__"`` key. ``like=`` optionally supplies an
    example pytree for orbax cross-process restores (its array leaves
    are used as the restore target shapes).
    """
    import pickle

    if use_orbax is None:
        use_orbax = _try_orbax() is not None and os.path.isdir(path)

    if use_orbax:
        ocp = _try_orbax()
        ckptr = ocp.StandardCheckpointer()
        path = os.path.abspath(path)
        target = None
        if like is not None:
            # abstract targets carrying the shardings: the restore then
            # places shards process-locally — the multi-host path
            # (concrete arrays as targets would make orbax fetch them,
            # which fails on non-addressable shards)
            target, _, _, _ = _split(like, keep_jax=True)
            target = {
                k: (jax.ShapeDtypeStruct(v.shape, v.dtype,
                                         sharding=v.sharding)
                    if isinstance(v, jax.Array) else v)
                for k, v in target.items()
            }
        if os.path.exists(_meta_path(path)):
            with open(_meta_path(path), "rb") as fh:
                meta = pickle.load(fh)
            restored = (ckptr.restore(path, target) if target is not None
                        else ckptr.restore(path))
            return _merge(restored, meta["statics"], meta["treedef"],
                          meta["n"])
        # legacy layout (pre-v2): the pytree was stored directly
        if like is not None:
            like = jax.tree_util.tree_map(np.asarray, like)
            return ckptr.restore(path, like)
        return ckptr.restore(path)

    if not path.endswith(".pkl"):
        path = path + ".pkl"
    with open(path, "rb") as fh:
        payload = pickle.load(fh)
    if isinstance(payload, dict) and payload.get(_V2):
        meta = payload["meta"]
        return _merge(payload["arrays"], meta["statics"],
                      meta["treedef"], meta["n"])
    return payload  # legacy pickle: the pytree itself
