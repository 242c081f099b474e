"""Weight export and import: HDF5 dumps of a model's parameters.

Counterpart of ``xvector_tpu/utils/export.py``.  Parity with the
reference's ``Model.save_prameters_to_h5`` weight export
(``models.py:180-214``), which walks the TF1 graph and writes each
variable under its scope path:

* :func:`export_h5` / :func:`import_h5` store each leaf of the
  ``(params, state)`` trees under ``/params/<path>/<to>/<leaf>`` and
  ``/state/...``; files written by either package load in the other.
* :func:`export_reference_h5` / :func:`import_reference_h5` use the
  reference's TF1 variable names, so a model trained by the reference
  migrates here without retraining, and back.

``h5py`` is imported inside each function that reads or writes a file.
Leaves go out as numpy arrays (tensors are detached and copied to the
host) and come back as ``torch`` tensors.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .. import resolve_device
from ..models import tdnn

__all__ = ["export_h5", "import_h5", "import_reference_h5",
           "export_reference_h5", "reference_named_weights"]


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _walk(tree: Any, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}/{i}")
    else:
        yield prefix, _numpy(tree)


def export_h5(path: str, params: Any, state: Any = None):
    import h5py
    with h5py.File(path, "w") as f:
        for name, arr in _walk(params, "/params"):
            f.create_dataset(name, data=arr)
        if state is not None:
            for name, arr in _walk(state, "/state"):
                f.create_dataset(name, data=arr)


def import_h5(path: str, like_params: Any, like_state: Any = None):
    """Load arrays back into trees shaped like the given templates; each
    leaf comes back as a tensor on its template leaf's device (the CPU
    where the template holds numpy arrays)."""
    import h5py

    def fill(tree, prefix, f):
        if isinstance(tree, dict):
            return {k: fill(v, f"{prefix}/{k}", f) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            out = [fill(v, f"{prefix}/{i}", f) for i, v in enumerate(tree)]
            return type(tree)(out) if isinstance(tree, tuple) else out
        dev = tree.device if isinstance(tree, torch.Tensor) else "cpu"
        return torch.from_numpy(np.asarray(f[prefix])).to(dev)

    with h5py.File(path, "r") as f:
        params = fill(like_params, "/params", f)
        state = (fill(like_state, "/state", f)
                 if like_state is not None else None)
    return params, state


def reference_named_weights(cfg, params, state) -> dict:
    """Map the port's (params, state) trees to the REFERENCE's TF1
    variable names (``models.py:55-101`` scopes + ``tf_block.py`` BN
    variables) — the inverse of :func:`import_reference_h5`'s naming.

    Returns ``{name: np.float32 array}`` with names like
    ``frame_level_info_layer-0/w:0`` exactly as the reference's h5
    export writes them, so a model trained HERE migrates back into the
    reference implementation."""
    out = {}

    def put_layer(scope, lay, st):
        out[scope + "/w:0"] = lay["w"]
        out[scope + "/b:0"] = lay["b"]
        out[scope + "/gamma:0"] = lay["bn"]["gamma"]
        out[scope + "/beta:0"] = lay["bn"]["beta"]
        out[scope + "/mean:0"] = st["mean"]
        out[scope + "/variance:0"] = st["var"]
        if "alpha" in lay:
            out[scope + "/prelu/prelu:0"] = lay["alpha"]

    for i in range(len(cfg.channels)):
        put_layer("frame_level_info_layer-%d" % i,
                  params["frame"][i], state["frame"][i])
    for i in range(len(cfg.embed_dims)):
        put_layer("embed_layer-%d" % i,
                  params["embed"][i], state["embed"][i])
    if cfg.pooling == "attention":
        out["attention/w:0"] = params["attention"]["w"]
        out["attention/b:0"] = params["attention"]["b"]
        out["attention/v:0"] = params["attention"]["v"]
    out["output/w:0"] = params["output"]["w"]
    out["output/b:0"] = params["output"]["b"]
    return {k: _numpy(v).astype(np.float32) for k, v in out.items()}


def export_reference_h5(path: str, cfg, params, state):
    """Write ``model.h5`` in the reference's naming scheme (see
    :func:`reference_named_weights`)."""
    import h5py
    with h5py.File(path, "w") as f:
        for name, arr in reference_named_weights(cfg, params, state).items():
            f.create_dataset(name, data=arr)


def import_reference_h5(path: str, cfg, num_classes: int, device="cuda"):
    """Import a model.h5 exported by the REFERENCE trainer
    (``models.py:180-214`` ``get_models_weights``) into the port's
    (params, state) trees on ``device`` — a trained TF1 x-vector model
    migrates without retraining.

    Reference naming (TF1 variable scopes, ``models.py:55-101``,
    ``tf_block.py:9-28``):

      frame_level_info_layer-{i}/{w,b,gamma,beta,mean,variance}:0
      embed_layer-{i}/{w,b,gamma,beta,mean,variance}:0
      output/{w,b}:0
      (PReLU variants: frame_level_info_layer-{i}/prelu/prelu:0)

    Conv kernels are (k, in, out) and affines (in, out) in both
    frameworks, so arrays transfer without transposition.  Missing BN
    population stats (the export writes them best-effort) fall back to
    the 0/1 init.  Shapes come from ``tdnn.init_params(cfg,
    num_classes)``; a mismatch raises ``ValueError``.
    """
    import h5py

    dev = resolve_device(device)
    params, state = tdnn.init_params(torch.Generator().manual_seed(0), cfg,
                                     num_classes, device="cpu")
    with h5py.File(path, "r") as f:
        names = {}
        f.visititems(lambda n, obj: names.update(
            {n: np.asarray(obj)}) if hasattr(obj, "shape") else None)

    def get(name, default=None):
        for cand in (name, name + ":0", "/" + name, "/" + name + ":0"):
            if cand in names:
                return names[cand]
        if default is not None:
            return default
        raise KeyError(f"reference h5 missing {name!r}; has e.g. "
                       f"{sorted(names)[:5]}")

    def put(dst, key, arr):
        want = tuple(dst[key].shape)
        arr = np.asarray(arr, np.float32)
        if arr.shape != want:
            raise ValueError(
                f"shape mismatch for {key}: h5 {arr.shape} vs model "
                f"{want} — wrong --model preset for this h5?")
        dst[key] = torch.from_numpy(arr.copy()).to(dev)

    def put_layer(scope, layer, st):
        put(layer, "w", get(f"{scope}/w"))
        put(layer, "b", get(f"{scope}/b"))
        put(layer["bn"], "gamma", get(f"{scope}/gamma"))
        put(layer["bn"], "beta", get(f"{scope}/beta"))
        put(st, "mean", get(f"{scope}/mean", _numpy(st["mean"])))
        put(st, "var", get(f"{scope}/variance", _numpy(st["var"])))
        if "alpha" in layer:
            put(layer, "alpha", get(f"{scope}/prelu/prelu"))

    for i in range(len(cfg.channels)):
        put_layer(f"frame_level_info_layer-{i}", params["frame"][i],
                  state["frame"][i])
    for i in range(len(cfg.embed_dims)):
        put_layer(f"embed_layer-{i}", params["embed"][i], state["embed"][i])
    if cfg.pooling == "attention":
        # models.py:1040-1044: attention scope {w, b, v}
        att = params["attention"]
        put(att, "w", get("attention/w"))
        put(att, "b", get("attention/b"))
        put(att, "v", get("attention/v"))
    put(params["output"], "w", get("output/w"))
    put(params["output"], "b", get("output/b"))
    return params, state
