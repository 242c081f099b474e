"""PyTorch/CUDA port of the x-vector framework, for NVIDIA Hopper (sm_90a).

The JAX package ``xvector_tpu`` is the reference; this package mirrors its
layout (``models/``, ``ops/``, ``extract/``, ``io/``, ``train/``,
``data/``, ``cli/``) so each module's counterpart is easy to find.  It imports ``torch`` and ``numpy`` only —
never ``jax`` and nothing of ``xvector_tpu``.

Entry points take ``device=`` (the CLIs ``--device``; default ``"cuda"``)
and raise when CUDA is absent unless the caller asks for ``"cpu"``.  Hand-written kernels
live in ``csrc/`` and are built from source at first use
(``ops/_build.py``); on CPU tensors each kernel wrapper runs its plain
PyTorch version instead.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if it names CUDA and no card
    is visible, so a run never carries on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev
