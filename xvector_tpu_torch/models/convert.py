"""Carry parameter pytrees between the JAX package and the port.

The JAX package keeps parameters as nested dicts and lists of arrays
(``params["frame"][i]["w"]`` of shape ``(K, Cin, Cout)`` and so on).  The
port keeps the same structure and layout with ``torch.Tensor`` leaves, so a
checkpoint's numpy arrays (``jax.tree.map(np.asarray, tree)``) load here
unchanged and the parity tests can hand both packages the same weights.
:func:`shard_params` and :func:`gather_params` move a tree between the
single-process layout and a rank's block of a mesh whose ``model`` axis
splits the classifier head's columns.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from .. import resolve_device

__all__ = ["tree_map", "tree_map2", "tree_leaves", "params_from_numpy", "params_to_numpy",
           "shard_params", "gather_params"]


def tree_map(fn: Callable[[Any], Any], tree):
    """Apply ``fn`` to every leaf of a nest of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_map2(fn: Callable[[Any, Any], Any], tree, other):
    """Apply ``fn`` to the leaves of ``tree`` paired with those of
    ``other``, a nest of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map2(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map2(fn, v, o) for v, o in zip(tree, other))
    return fn(tree, other)


def tree_leaves(tree) -> list:
    """The leaves of a nest of dicts, lists and tuples, in a fixed order
    (dict insertion order, then list order)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def params_from_numpy(params_np, state_np, device="cuda"):
    """numpy ``(params, state)`` trees → the port's tensors on ``device``,
    same structure, dtype and layout."""
    dev = resolve_device(device)

    def to_tensor(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    return tree_map(to_tensor, params_np), tree_map(to_tensor, state_np)


def params_to_numpy(params, state):
    """Inverse of :func:`params_from_numpy`."""
    def to_numpy(t):
        return t.detach().cpu().numpy()

    return tree_map(to_numpy, params), tree_map(to_numpy, state)


def shard_params(params, mesh):
    """This rank's params under ``mesh``: the head's columns
    (``params["output"]``'s ``w`` (D, C) and ``b`` (C,)) split over the
    ``model`` axis, every other tensor as it is; new tensors.  Raises
    ``ValueError`` when C is not divisible by the axis."""
    from ..parallel import mesh as meshlib
    layout = meshlib.param_shardings(mesh, params)
    return tree_map2(lambda t, s: s.local(t).contiguous().clone(), params,
                     layout)


def gather_params(params, mesh):
    """Inverse of :func:`shard_params`: the head's whole columns,
    gathered over the ``model`` axis (collective: every rank of the axis
    calls it), every other tensor as it is."""
    from ..parallel import mesh as meshlib
    layout = meshlib.param_shardings(mesh, params)

    def gather(t, s):
        if s.axis is None:
            return t
        return meshlib.gather_dim(t, s.dim, mesh.group(s.axis))

    return tree_map2(gather, params, layout)
