"""Carry parameter pytrees between the JAX package and the port.

The JAX package keeps parameters as nested dicts and lists of arrays
(``params["frame"][i]["w"]`` of shape ``(K, Cin, Cout)`` and so on).  The
port keeps the same structure and layout with ``torch.Tensor`` leaves, so a
checkpoint's numpy arrays (``jax.tree.map(np.asarray, tree)``) load here
unchanged and the parity tests can hand both packages the same weights.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from .. import resolve_device

__all__ = ["tree_map", "params_from_numpy", "params_to_numpy"]


def tree_map(fn: Callable[[Any], Any], tree):
    """Apply ``fn`` to every leaf of a nest of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


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
