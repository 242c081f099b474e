"""The port's feature front end (``xvector_tpu_torch/ops/features.py``)
against the JAX package's on the same seeded inputs, on the CPU.

Bounds are the JAX package's own (``tests/test_features.py``): features
rtol 1e-4, atol 1e-3 (the DC-heavy rows atol 2e-3, as there); the golden
fixtures rtol 2e-4, atol 1e-3; CMVN rtol 1e-4, atol 2e-3; VAD decisions
and voiced compaction exact; host constants 1e-6."""

import os

import jax
import numpy as np
import pytest
import torch

from xvector_tpu.ops import features as JF
from xvector_tpu_torch.ops import features as TF

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "feature_golden.npz")
VARIANTS = [
    dict(),
    dict(raw_energy=False),
    dict(remove_dc_offset=False),
    dict(preemph=0.0),
    dict(use_energy=False, cepstral_lifter=0.0),
    dict(raw_energy=False, use_energy=False),
    dict(snip_edges=True),
]
VARIANT_IDS = ["default", "raw_energy_off", "no_dc", "no_preemph",
               "no_energy", "no_raw_no_energy", "snip_edges"]


def _cfgs(**kw):
    return JF.MfccConfig(dither=0.0, **kw), TF.MfccConfig(dither=0.0, **kw)


def _ragged_waves(lens, seed=0, scale=2000.0):
    rng = np.random.RandomState(seed)
    waves = np.zeros((len(lens), max(lens)), np.float32)
    for i, n in enumerate(lens):
        waves[i, :n] = (rng.randn(n) * scale).astype(np.float32)
    return waves, np.asarray(lens, np.int32)


def _batch_both(waves, lens, jcfg, tcfg):
    jf, jm = JF.mfcc_batch(waves, lens, jcfg)
    tf_, tm = TF.mfcc_batch(torch.from_numpy(waves), torch.from_numpy(lens),
                            tcfg)
    return np.asarray(jf), np.asarray(jm), tf_.numpy(), tm.numpy()


def _assert_rows(jf, jm, tf_, tm, atol=1e-3):
    np.testing.assert_array_equal(tm, jm)
    for i in range(jm.shape[0]):
        t = int(jm[i].sum())
        np.testing.assert_allclose(tf_[i, :t], jf[i, :t], rtol=1e-4,
                                   atol=atol)


@pytest.mark.parametrize("kw", VARIANTS, ids=VARIANT_IDS)
def test_mfcc_batch_matches_jax(kw):
    """Ragged rows of 8000, 5000 and 123 samples under each config variant
    (each folds a different DFT matrix; raw_energy=False takes the
    per-frame chain)."""
    jcfg, tcfg = _cfgs(**kw)
    waves, lens = _ragged_waves([8000, 5000, 123], seed=11)
    _assert_rows(*_batch_both(waves, lens, jcfg, tcfg))


@pytest.mark.parametrize("kw", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("n", [8000, 123])
def test_mfcc_matches_jax(kw, n):
    jcfg, tcfg = _cfgs(**kw)
    wave = _ragged_waves([n], seed=12)[0][0]
    want = np.asarray(JF.mfcc(wave, jcfg))
    got = TF.mfcc(torch.from_numpy(wave), tcfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)


def test_mfcc_batch_dc_offset_heavy():
    """DC offset ≫ AC power: the energy must come from mean-subtracted
    samples (the JAX test's bound, atol 2e-3)."""
    rng = np.random.RandomState(7)
    lens = [8000, 4000]
    waves = np.zeros((2, 8000), np.float32)
    for i, ln in enumerate(lens):
        waves[i, :ln] = (8000.0 + 5.0 * rng.randn(ln)).astype(np.float32)
    _assert_rows(*_batch_both(waves, np.asarray(lens, np.int32), *_cfgs()),
                 atol=2e-3)


def test_mfcc_batch_buffer_shorter_than_reflection():
    """A 50-sample buffer is narrower than the 60-sample left reflection:
    every frame is a tail frame."""
    waves, lens = _ragged_waves([50, 30], seed=9)
    _assert_rows(*_batch_both(waves, lens, *_cfgs()))


def test_mfcc_batch_rows_match_single():
    waves, lens = _ragged_waves([8000, 5000, 12000, 123])
    _, tcfg = _cfgs()
    feats, mask = TF.mfcc_batch(torch.from_numpy(waves),
                                torch.from_numpy(lens), tcfg)
    for i, n in enumerate(lens):
        ref = TF.mfcc(torch.from_numpy(waves[i, :n]), tcfg)
        t = ref.shape[0]
        assert mask[i].sum() == t
        np.testing.assert_allclose(feats[i, :t].numpy(), ref.numpy(),
                                   rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("snip", [False, True])
@pytest.mark.parametrize("n", [0, 150, 199, 200, 8000, 12345])
def test_num_frames_matches_jax(snip, n):
    jcfg, tcfg = _cfgs(snip_edges=snip)
    assert TF.num_frames(n, tcfg) == JF.num_frames(n, jcfg)
    if n:
        np.testing.assert_array_equal(TF._frame_indices(n, tcfg),
                                      JF._frame_indices(n, jcfg))


@pytest.mark.parametrize("case", [0, 1, 2])
def test_mfcc_matches_golden(case):
    g = np.load(GOLDEN)
    got = TF.mfcc(torch.from_numpy(g[f"wave_{case}"].astype(np.float32)),
                  TF.MfccConfig(dither=0.0)).numpy()
    want = g[f"mfcc_{case}"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-3)


@pytest.mark.parametrize("case", [0, 1, 2])
def test_vad_matches_golden(case):
    g = np.load(GOLDEN)
    feats = torch.from_numpy(g[f"mfcc_{case}"].astype(np.float32))
    np.testing.assert_array_equal(TF.energy_vad(feats).numpy(),
                                  g[f"vad_{case}"])


@pytest.mark.parametrize("ctx,prop", [(2, 0.12), (0, 0.5), (5, 0.3)])
def test_energy_vad_matches_jax(ctx, prop):
    rng = np.random.RandomState(11 + ctx)
    feats = (rng.randn(400, 23) * 3.0).astype(np.float32)
    feats[:, 0] = (rng.randn(400) * 4.0 + 2.0).astype(np.float32)
    vcfg = dict(frames_context=ctx, proportion_threshold=prop)
    want = np.asarray(JF.energy_vad(feats, JF.VadConfig(**vcfg)))
    got = TF.energy_vad(torch.from_numpy(feats), TF.VadConfig(**vcfg))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_energy_vad_batch_matches_jax():
    waves, lens = _ragged_waves([8000, 3000, 11000], seed=1)
    jcfg, tcfg = _cfgs()
    jf, jm = JF.mfcc_batch(waves, lens, jcfg)
    feats, mask = np.array(jf), np.array(jm)
    want = np.asarray(JF.energy_vad_batch(feats, mask))
    got = TF.energy_vad_batch(torch.from_numpy(feats),
                              torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    for i, n in enumerate(lens):     # rows equal the single-utterance op
        t = TF.num_frames(int(n), tcfg)
        np.testing.assert_array_equal(
            got[i, :t], TF.energy_vad(torch.from_numpy(feats[i, :t])))
        assert not got[i, t:].any()


@pytest.mark.parametrize("window,center,norm_var", [
    (300, True, False), (10, True, False), (300, False, False),
    (50, True, True)])
def test_sliding_cmvn_batch_matches_jax(window, center, norm_var):
    waves, lens = _ragged_waves([8000, 2000, 20000, 900], seed=2)
    jf, jm = JF.mfcc_batch(waves, lens, _cfgs()[0])
    feats, mask = np.array(jf), np.array(jm)
    want = np.asarray(JF.sliding_cmvn_batch(feats, mask, window=window,
                                            center=center,
                                            normalize_variance=norm_var))
    got = TF.sliding_cmvn_batch(torch.from_numpy(feats),
                                torch.from_numpy(mask), window=window,
                                center=center,
                                normalize_variance=norm_var).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-3)
    assert not got[mask == 0].any()


def test_sliding_cmvn_batch_long_rows():
    """~10k and ~6k frames: the prefix-sum differences must stay accurate
    over long rows, against the JAX batch op and the single-utterance
    op."""
    waves, lens = _ragged_waves([800_640, 500_000], seed=7)
    jf, jm = JF.mfcc_batch(waves, lens, _cfgs()[0])
    feats, mask = np.array(jf), np.array(jm)
    want = np.asarray(JF.sliding_cmvn_batch(feats, mask, window=300))
    got = TF.sliding_cmvn_batch(torch.from_numpy(feats),
                                torch.from_numpy(mask), window=300).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-3)
    for i in range(2):
        t = int(mask[i].sum())
        ref = TF.sliding_cmvn(torch.from_numpy(feats[i, :t]), window=300)
        np.testing.assert_allclose(got[i, :t], ref.numpy(), rtol=1e-4,
                                   atol=2e-3)


def test_compact_voiced_matches_jax():
    rng = np.random.RandomState(3)
    feats = rng.randn(3, 50, 7).astype(np.float32)
    vad = (rng.rand(3, 50) > 0.4).astype(np.float32)
    vad[1, 40:] = 0.0
    vad[2] = 0.0                              # no voiced frame at all
    jo, jm = JF.compact_voiced(feats, vad)
    to, tm = TF.compact_voiced(torch.from_numpy(feats), torch.from_numpy(vad))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    for i in range(3):
        k = int(vad[i].sum())
        np.testing.assert_array_equal(to[i, :k].numpy(),
                                      TF.select_voiced_frames(feats[i],
                                                              vad[i]))


@pytest.mark.parametrize("kw", VARIANTS + [dict(window_type="hamming")],
                         ids=VARIANT_IDS + ["hamming"])
def test_host_constants_match_jax(kw):
    jcfg, tcfg = _cfgs(**kw)
    pairs = [(TF._window_fn(tcfg), JF._window_fn(jcfg)),
             (TF._mel_banks(tcfg), JF._mel_banks(jcfg)),
             (TF._dct_matrix(23, 23), JF._dct_matrix(23, 23)),
             (TF._dct_matrix(13, 23), JF._dct_matrix(13, 23)),
             (TF._lifter_coeffs(23, 22.0), JF._lifter_coeffs(23, 22.0)),
             (TF._folded_dft(tcfg), JF._folded_dft(jcfg)),
             *zip(TF._dft_matrices(tcfg), JF._dft_matrices(jcfg))]
    for got, want in pairs:
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_mfcc_batch_dither_deterministic_and_bounded():
    """The same generator seed gives the same bits (including a 300-sample
    row whose every frame is a tail frame), another seed other bits, and
    the dithered output stays near the clean one."""
    waves, lens = _ragged_waves([8000, 300], seed=3)
    w, n = torch.from_numpy(waves), torch.from_numpy(lens)
    cfg = TF.MfccConfig()                     # dither 1.0

    def run(seed):
        return TF.mfcc_batch(w, n, cfg,
                             torch.Generator().manual_seed(seed))[0]

    a1, a2, b1 = run(5), run(5), run(6)
    assert torch.equal(a1, a2)
    assert (a1 - b1).abs().max() > 0.0
    clean, mask = TF.mfcc_batch(w, n, TF.MfccConfig(dither=0.0))
    assert ((a1 - clean).abs() * mask[..., None]).max() < 1.0
    # dither=0 ignores the generator
    off = TF.mfcc_batch(w, n, TF.MfccConfig(dither=0.0),
                        torch.Generator().manual_seed(5))[0]
    assert torch.equal(off, clean)


def test_mfcc_dither_deterministic():
    wave = torch.from_numpy(_ragged_waves([4000], seed=4)[0][0])
    cfg = TF.MfccConfig()
    a = TF.mfcc(wave, cfg, torch.Generator().manual_seed(1))
    b = TF.mfcc(wave, cfg, torch.Generator().manual_seed(1))
    c = TF.mfcc(wave, cfg, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and (a - c).abs().max() > 0.0
    assert (a - TF.mfcc(wave, TF.MfccConfig(dither=0.0))).abs().max() < 1.0


def test_configs_carry_the_same_defaults():
    for jc, tc in ((JF.MfccConfig(), TF.MfccConfig()),
                   (JF.VadConfig(), TF.VadConfig())):
        assert jax.tree.leaves(vars(jc)) == jax.tree.leaves(vars(tc))
    assert (TF.MfccConfig().frame_length, TF.MfccConfig().frame_shift,
            TF.MfccConfig().fft_size) == (200, 80, 256)
