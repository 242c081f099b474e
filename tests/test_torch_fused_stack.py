"""K1, the fused TDNN frame stack: the port's plain version
(fused_frame_stack_reference, layer 0 in the packed form of its Hopper
kernel) against the JAX Pallas kernel in interpret mode, the fold's
padding, the extractors' fold-once, and the dispatcher's device routing.

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
from xvector_tpu_torch.extract import extractor as TE
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


@pytest.mark.parametrize("feat,act", [(4, "relu"), (23, "lrelu"),
                                      (40, "prelu")])
def test_packed_layer_zero_stack_matches_pallas_interpret(feat, act):
    """The stack through a fold (layer 0 as l0_reference: im2col of the
    masked bf16 features times W0 padded to 64, 128 or 256 rows) against
    JAX's K1 in interpret mode, with holes in the mask."""
    cfg = _mini_cfg(feat_dim=feat, activation=act)
    jp, js, tp, ts = model_pair(cfg, seed=feat)
    rng = np.random.RandomState(feat)
    x = rng.randn(2, 40, feat).astype(np.float32)
    mask = _mask("random", 2, 40, rng)
    want = np.asarray(JK.fused_frame_stack(cfg, jp, js, jnp.asarray(x),
                                           jnp.asarray(mask), t_tile=16,
                                           interpret=True))
    pcfg = port_cfg(cfg)
    folded = TK.fold_stack(pcfg, tp, ts)
    assert folded.w0.shape[0] == -(-5 * feat // 64) * 64
    got = TK.fused_frame_stack_reference(
        pcfg, folded, None, torch.from_numpy(x),
        torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (2, 40, 24)
    assert _norm_err(got, want) <= BOUND
    assert not got[mask == 0].any()


def test_fold_padding_is_bit_exact():
    """Channel counts off 8 (12 inside, 20 last) padded to 16 and 24 by the
    fold give the same bits as the unpadded fold: padded columns are exact
    zeros and the next layer's zero rows add exact zeros."""
    cfg = _mini_cfg(channels=(8, 12, 8, 8, 20), activation="prelu")
    _, _, tp, ts = model_pair(cfg, seed=3)
    pcfg = port_cfg(cfg)
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(3, 45, 4).astype(np.float32))
    mask = torch.from_numpy(_mask("random", 3, 45, rng))
    padded = TK.fold_stack(pcfg, tp, ts)
    assert [w.shape[2] for w, *_ in padded.layers] == [8, 16, 8, 8, 24]
    got = TK.fused_frame_stack_reference(pcfg, padded, None, x, mask)
    want = TK.fused_frame_stack_reference(
        pcfg, TK.fold_stack(pcfg, tp, ts, pad=False), None, x, mask)
    assert got.shape == want.shape == (3, 45, 20)
    assert torch.equal(got, want)


def test_extractors_fold_once(monkeypatch):
    """XvectorExtractor folds K1's parameters at construction and
    make_wave_to_xvector once per (params, state) pair, not per batch;
    the x-vectors equal those of per-call folding."""
    cfg = port_cfg(_mini_cfg(activation="lrelu"))
    _, _, tp, ts = model_pair(_mini_cfg(activation="lrelu"), seed=5)
    folds = []
    fold = TK.fold_stack
    monkeypatch.setattr(TK, "fold_stack",
                        lambda *a, **k: folds.append(1) or fold(*a, **k))
    rng = np.random.RandomState(5)
    utts = [(f"u{i}", rng.randn(n, 4).astype(np.float32))
            for i, n in enumerate([20, 50, 130, 9, 70])]
    ecfg = TE.ExtractorConfig(use_fused=True, min_chunk=5, max_chunk=64,
                              batch_size=2)
    ex = TE.XvectorExtractor(cfg, tp, ts, ecfg, device="cpu")
    got = ex.extract(utts)
    assert len(folds) == 1
    ex.folded = None                  # _xvector folds on every call
    want = ex.extract(utts)
    assert len(folds) > 3
    assert set(got) == set(want) == {u for u, _ in utts}
    for u in got:
        np.testing.assert_array_equal(got[u], want[u])

    del folds[:]
    fn = TE.make_wave_to_xvector(cfg, TE.F.MfccConfig(dither=0.0),
                                 compute_dtype=torch.float32, use_fused=True,
                                 device="cpu")
    waves = torch.from_numpy(rng.randn(2, 4000).astype(np.float32) * 2000)
    n = torch.tensor([4000, 3000])
    first = fn(tp, ts, waves, n)[0]
    torch.testing.assert_close(fn(tp, ts, waves, n)[0], first, rtol=0,
                               atol=0)
    assert len(folds) == 1
    torch.testing.assert_close(fn(dict(tp), ts, waves, n)[0], first, rtol=0,
                               atol=0)
    assert len(folds) == 2
