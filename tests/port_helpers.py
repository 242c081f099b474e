"""Shared set-up for the PyTorch port's parity tests (tests/test_torch_*):
one numpy copy of the weights goes to both the JAX reference and the
port, so the tests compare computations, never initialisations."""

import jax
import numpy as np

from xvector_tpu.models import tdnn as jt
from xvector_tpu_torch.models import tdnn as tt
from xvector_tpu_torch.models.convert import params_from_numpy


def port_cfg(cfg: jt.TdnnConfig) -> tt.TdnnConfig:
    """The port's TdnnConfig with the same field values."""
    return tt.TdnnConfig(**{f: getattr(cfg, f)
                            for f in tt.TdnnConfig.__dataclass_fields__})


def model_pair(cfg: jt.TdnnConfig, seed: int = 0, num_classes: int = 7):
    """(JAX params, JAX state, port params, port state) holding the same
    numbers, with BN state, γ/β and prelu α perturbed away from their
    initial values so that the folded batch norm is exercised."""
    params, state = jt.init_params(jax.random.PRNGKey(seed), cfg,
                                   num_classes)
    rng = np.random.RandomState(seed + 100)
    state = jax.tree.map(
        lambda a: np.asarray(a) + 0.3 * rng.rand(*a.shape).astype(np.float32),
        state)
    params = jax.tree.map(np.asarray, params)
    for layer in params["frame"] + params["embed"]:
        bn = layer["bn"]
        bn["gamma"] = (bn["gamma"] + 0.2 * rng.randn(*bn["gamma"].shape)
                       ).astype(np.float32)
        bn["beta"] = (0.1 * rng.randn(*bn["beta"].shape)).astype(np.float32)
        if "alpha" in layer:
            layer["alpha"] = (0.1 + 0.05 * rng.randn(*layer["alpha"].shape)
                              ).astype(np.float32)
    return (params, state,
            *params_from_numpy(params, state, device="cpu"))
