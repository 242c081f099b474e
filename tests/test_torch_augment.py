"""The port's augmentation (``xvector_tpu_torch/ops/augment.py``) against
the JAX package's ``ops/augment.py`` on the same seeded signals, on the
CPU: values within 1e-4 of the JAX output's scale, the same picks from
equal ``RandomState``s, and the SNR hit."""

import numpy as np
import pytest
import torch

from xvector_tpu.ops import augment as JA
from xvector_tpu_torch.ops import augment as TA

BOUND = 1e-4


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= BOUND, err


@pytest.mark.parametrize("k", [1, 33, 257, 4000])
@pytest.mark.parametrize("n", [777, 4096, 12345])
def test_fir_conv_matches_jax(k, n):
    rng = np.random.RandomState(k + n)
    x = (rng.randn(n) * 1000).astype(np.float32)
    h = (np.exp(-np.arange(k) / max(k / 8, 1)) * rng.randn(k)).astype(
        np.float32)
    got = TA.fir_conv(torch.from_numpy(x), torch.from_numpy(h))
    _close(got.numpy(), JA.fir_conv(x, h))
    np.testing.assert_allclose(got.numpy(), np.convolve(x, h)[:n],
                               rtol=1e-5, atol=1e-5 * np.abs(x).max())


def test_reverberate_matches_jax():
    rng = np.random.RandomState(2)
    x = (rng.randn(4000) * 1000).astype(np.float32)
    rir = (np.exp(-np.arange(200) / 30.0) * rng.randn(200)).astype(
        np.float32)
    for norm in (True, False):
        got = TA.reverberate(torch.from_numpy(x), torch.from_numpy(rir),
                             normalize_power=norm).numpy()
        _close(got, JA.reverberate(x, rir, normalize_power=norm))
    y = TA.reverberate(torch.from_numpy(x), torch.from_numpy(rir)).numpy()
    assert abs(np.mean(y.astype(np.float64) ** 2)
               / np.mean(x.astype(np.float64) ** 2) - 1.0) < 1e-5


@pytest.mark.parametrize("offset", [0, 1234, 2999])
@pytest.mark.parametrize("snr", [0.0, 5.0, 13.0])
def test_mix_noise_matches_jax(offset, snr):
    """Noise shorter than the signal is tiled from ``offset``."""
    rng = np.random.RandomState(3)
    x = (rng.randn(8000) * 1000).astype(np.float32)
    noise = (rng.randn(3000) * 10).astype(np.float32)
    got = TA.mix_noise(torch.from_numpy(x), torch.from_numpy(noise), snr,
                       offset=offset).numpy()
    _close(got, JA.mix_noise(x, noise, snr, offset=offset))
    np.testing.assert_array_equal(
        TA._fit_length(torch.from_numpy(noise), 8000, offset).numpy(),
        np.asarray(JA._fit_length(noise, 8000, offset)))
    added = got.astype(np.float64) - x
    hit = 10 * np.log10(np.mean(x.astype(np.float64) ** 2)
                        / np.mean(added ** 2))
    assert abs(hit - snr) < 0.05


def _assets(seed):
    rng = np.random.RandomState(seed)
    return dict(
        rirs={"small": [(np.exp(-np.arange(50) / 10) * rng.randn(50)
                         ).astype(np.float32) for _ in range(3)],
              "medium": [(np.exp(-np.arange(300) / 60) * rng.randn(300)
                          ).astype(np.float32) for _ in range(2)]},
        noises=[(rng.randn(n) * 300).astype(np.float32)
                for n in (500, 3000, 9000)],
        musics=[(rng.randn(n) * 200).astype(np.float32)
                for n in (800, 20000)],
        speeches=[(rng.randn(n) * 1000).astype(np.float32)
                  for n in (600, 2500, 4000, 1000, 7000, 3000, 900, 5000)])


@pytest.mark.parametrize("kind", ["reverb", "noise", "music", "babble"])
def test_augment_utterance_matches_jax(kind):
    """Equal RandomStates draw the same picks in both packages (the states
    end equal), and the copies agree within 1e-4."""
    x = (np.random.RandomState(4).randn(6000) * 500).astype(np.float32)
    assets = _assets(5)
    cfg_j, cfg_t = JA.AugmentConfig(), TA.AugmentConfig()
    rng_j, rng_t = np.random.RandomState(6), np.random.RandomState(6)
    for _ in range(3):
        want = JA.augment_utterance(kind, x, rng_j, cfg_j, **assets)
        got = TA.augment_utterance(kind, x, rng_t, cfg_t, device="cpu",
                                   **assets)
        _close(got, want)
        assert not np.allclose(got, x)
    assert rng_j.randint(1 << 30) == rng_t.randint(1 << 30)


def test_augment_utterance_flat_rir_list_and_bad_kind():
    x = (np.random.RandomState(7).randn(3000) * 500).astype(np.float32)
    rirs = _assets(8)["rirs"]["small"]
    got = TA.augment_utterance("reverb", x, np.random.RandomState(1),
                               TA.AugmentConfig(), rirs=rirs, device="cpu")
    _close(got, JA.augment_utterance("reverb", x, np.random.RandomState(1),
                                     JA.AugmentConfig(), rirs=rirs))
    with pytest.raises(ValueError, match="kind"):
        TA.augment_utterance("tremolo", x, np.random.RandomState(1),
                             TA.AugmentConfig(), device="cpu")


def test_snr_sets_match_jax():
    assert (TA.NOISE_SNRS, TA.MUSIC_SNRS, TA.BABBLE_SNRS) == (
        JA.NOISE_SNRS, JA.MUSIC_SNRS, JA.BABBLE_SNRS)
    assert TA.AugmentConfig() == TA.AugmentConfig(*vars(
        JA.AugmentConfig()).values())
