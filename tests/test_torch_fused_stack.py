"""K1, the fused TDNN frame stack: the port's plain version
(fused_frame_stack_reference) against the JAX Pallas kernel in interpret
mode, and the dispatcher's device routing.

Bound: max |port − JAX| / max |JAX| ≤ 1e-2.  Both sides round the same
operands to bf16 and accumulate in f32, so they differ only in summation
order; measured on these cases the normalised error is ≤ 5e-6.  The
kernel itself is held to the plain version on the card by
tests/test_torch_cuda.py."""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xvector_tpu.models import tdnn as jt
from xvector_tpu.ops import tdnn_kernel as JK
from xvector_tpu_torch.models import tdnn as tt
from xvector_tpu_torch.ops import tdnn_kernel as TK

from port_helpers import model_pair, port_cfg

BOUND = 1e-2


def _mini_cfg(**kw):
    base = dict(kernel_sizes=(5, 3, 3, 1, 1), dilations=(1, 2, 3, 1, 1),
                channels=(8, 8, 8, 8, 24), feat_dim=4, embed_dims=(6, 6))
    base.update(kw)
    return replace(jt.MODEL_ZOO["no_dropout"], **base)


def _norm_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


CASES = {
    # name: (config overrides, B, T, mask kind)
    "relu": (dict(), 2, 50, "random"),
    "lrelu": (dict(activation="lrelu"), 2, 50, "random"),
    "prelu": (dict(activation="prelu"), 2, 50, "random"),
    "dilated_wide": (dict(kernel_sizes=(5, 1, 3, 1, 3, 1, 1),
                          dilations=(1, 1, 2, 1, 4, 1, 1),
                          channels=(16, 8, 16, 8, 16, 8, 20)), 2, 45,
                     "random"),
    "ragged_t": (dict(), 1, 37, "ones"),
    "padded_tails": (dict(), 3, 48, "tails"),
}


def _mask(kind, b, t, rng):
    if kind == "ones":
        return np.ones((b, t), np.float32)
    if kind == "random":
        return (rng.rand(b, t) > 0.2).astype(np.float32)
    mask = np.zeros((b, t), np.float32)
    for i, n in enumerate(rng.randint(t // 3, t + 1, size=b)):
        mask[i, :n] = 1.0
    return mask


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_pallas_interpret(case):
    kw, b, t, kind = CASES[case]
    cfg = _mini_cfg(**kw)
    jp, js, tp, ts = model_pair(cfg, seed=len(case))
    rng = np.random.RandomState(7)
    x = rng.randn(b, t, cfg.feat_dim).astype(np.float32)
    mask = _mask(kind, b, t, rng)
    want = np.asarray(JK.fused_frame_stack(cfg, jp, js, jnp.asarray(x),
                                           jnp.asarray(mask), t_tile=16,
                                           interpret=True))
    got = TK.fused_frame_stack_reference(
        port_cfg(cfg), tp, ts, torch.from_numpy(x),
        torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (b, t, cfg.channels[-1])
    assert got.dtype == np.float32
    assert _norm_err(got, want) <= BOUND
    assert not got[mask == 0].any()          # masked frames are exact zeros


@pytest.mark.parametrize("name", sorted(jt.MODEL_ZOO))
def test_supports_and_halo_match_jax(name):
    cfg = jt.MODEL_ZOO[name]
    pcfg = tt.MODEL_ZOO[name]
    assert pcfg == port_cfg(cfg)
    assert TK.supports(pcfg) == JK.supports(cfg)
    assert TK._halo(pcfg) == JK._halo(cfg)


def test_cpu_tensor_takes_plain_path_without_launch():
    cfg = port_cfg(_mini_cfg(activation="prelu"))
    _, _, tp, ts = model_pair(_mini_cfg(activation="prelu"))
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 33, 4)
                         .astype(np.float32))
    TK.launches = 0
    got = TK.fused_frame_stack(cfg, tp, ts, x)
    assert TK.launches == 0
    torch.testing.assert_close(
        got, TK.fused_frame_stack_reference(cfg, tp, ts, x), rtol=0, atol=0)


def test_rejects_attention_topology():
    cfg = replace(tt.MODEL_ZOO["l2_lrelu_attention"],
                  channels=(8, 8, 8, 8, 16), embed_dims=(12, 12))
    with pytest.raises(ValueError):
        TK.fused_frame_stack(cfg, None, None, torch.zeros(1, 30, 23))
