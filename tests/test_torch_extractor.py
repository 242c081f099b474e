"""Port's batched extractor (xvector_tpu_torch.extract.extractor) against
the JAX XvectorExtractor on the same utterances and weights.

Tolerances: 1e-4 for the f32 paths; 5e-2 for the port's fused path (K1's
bf16 numerics, plain version on the CPU) against the JAX f32 output, the
bound tests/test_tdnn_kernel.py allows the fused stack; 1e-5 for CMVN."""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xvector_tpu.extract import extractor as JE
from xvector_tpu.models import tdnn as jt
from xvector_tpu.ops import features as JF
from xvector_tpu_torch.extract import extractor as TE
from xvector_tpu_torch.models import tdnn as tt
from xvector_tpu_torch.ops import features as TF
from xvector_tpu_torch.ops import tdnn_kernel as TK

from port_helpers import model_pair, port_cfg

CFG = replace(jt.MODEL_ZOO["tiny"], channels=(16, 16, 16, 16, 40),
              embed_dims=(24, 24))
COMMON = dict(min_chunk=25, max_chunk=100, batch_size=3,
              buckets=(32, 64, 128))


@pytest.fixture(scope="module")
def model():
    return model_pair(CFG, seed=4)


def _utterances():
    """Multi-chunk (250 → 100+100+50; 210 → 100+100, 10-frame tail
    dropped), too short to keep (12), and enough 64-bucket chunks to fill
    several batches, across three buckets."""
    rng = np.random.RandomState(0)
    lens = [250, 210, 12, 40, 60, 45, 90, 33, 50, 64, 58, 120, 27]
    return [(f"u{i:02d}", rng.randn(n, 23).astype(np.float32))
            for i, n in enumerate(lens)]


def _both(model, **kw):
    jp, js, tp, ts = model
    ecfg = dict(COMMON, **kw)
    want = JE.XvectorExtractor(CFG, jp, js, JE.ExtractorConfig(
        **{k: v for k, v in ecfg.items() if k != "use_fused"})
    ).extract(_utterances())
    got = TE.XvectorExtractor(port_cfg(CFG), tp, ts,
                              TE.ExtractorConfig(**ecfg), device="cpu"
                              ).extract(_utterances())
    return got, want


@pytest.mark.parametrize("depth", [1, 2])
def test_extractor_matches_jax(model, depth):
    got, want = _both(model, dispatch_depth=depth)
    assert set(got) == set(want) == {u for u, f in _utterances()
                                     if len(f) >= 25}
    for utt in want:
        assert got[utt].dtype == np.float32
        np.testing.assert_allclose(got[utt], want[utt], rtol=1e-4,
                                   atol=1e-4)


def test_completion_order_matches_jax(model):
    jp, js, tp, ts = model
    want = [u for u, _ in JE.XvectorExtractor(
        CFG, jp, js, JE.ExtractorConfig(**COMMON)).extract_iter(
            _utterances())]
    got = [u for u, _ in TE.XvectorExtractor(
        port_cfg(CFG), tp, ts, TE.ExtractorConfig(**COMMON),
        device="cpu").extract_iter(_utterances())]
    assert got == want


def test_fused_on_cpu_matches_jax_f32(model):
    TK.launches = 0
    got, want = _both(model, use_fused=True, compute_dtype="bfloat16")
    assert TK.launches == 0          # CPU tensors take the plain version
    assert set(got) == set(want)
    for utt in want:   # normalised by the vector's scale; measured 3.5e-3
        err = np.abs(got[utt] - want[utt]).max() / np.abs(want[utt]).max()
        assert err <= 5e-2, (utt, err)


def test_attention_extractor_matches_jax():
    """An attention-pooling topology takes the unfused path."""
    cfg = replace(jt.MODEL_ZOO["l2_lrelu_attention"],
                  channels=(16, 16, 16, 16, 24), embed_dims=(12, 12))
    jp, js, tp, ts = model_pair(cfg, seed=5)
    want = JE.XvectorExtractor(cfg, jp, js, JE.ExtractorConfig(**COMMON)
                               ).extract(_utterances())
    got = TE.XvectorExtractor(port_cfg(cfg), tp, ts,
                              TE.ExtractorConfig(**COMMON), device="cpu"
                              ).extract(_utterances())
    assert set(got) == set(want)
    for utt in want:
        np.testing.assert_allclose(got[utt], want[utt], rtol=1e-4,
                                   atol=1e-4)


def test_fused_rejects_unsupported_topology():
    cfg = replace(tt.MODEL_ZOO["l2_lrelu_attention"],
                  channels=(8, 8, 8, 8, 16), embed_dims=(12, 12))
    tp, ts = tt.init_params(torch.Generator().manual_seed(0), cfg, 3,
                            device="cpu")
    with pytest.raises(ValueError):
        TE.XvectorExtractor(cfg, tp, ts, TE.ExtractorConfig(use_fused=True),
                            device="cpu")


@pytest.mark.parametrize("t,window,center,norm_var", [
    (400, 300, True, False), (400, 300, False, False),
    (120, 300, True, False), (257, 50, True, True)])
def test_sliding_cmvn_matches_jax(t, window, center, norm_var):
    rng = np.random.RandomState(t)
    feats = (rng.randn(t, 23) * 3 + 7).astype(np.float32)
    want = np.asarray(JF.sliding_cmvn(jnp.asarray(feats), window=window,
                                      center=center,
                                      normalize_variance=norm_var))
    got = TF.sliding_cmvn(torch.from_numpy(feats), window=window,
                          center=center,
                          normalize_variance=norm_var).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_preprocess_matches_jax():
    rng = np.random.RandomState(4)
    feats = (rng.randn(400, 23) + 7.0).astype(np.float32)
    vad = (rng.rand(400) > 0.3).astype(np.float32)
    want = JE.preprocess(feats, cmvn_window=300, vad=vad)
    got = TE.preprocess(feats, cmvn_window=300, vad=vad, device="cpu")
    assert got.shape == want.shape == (int(vad.sum()), 23)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(TF.select_voiced_frames(feats, vad),
                                  JF.select_voiced_frames(feats, vad))


@pytest.mark.parametrize("case", ["mixed", "all_voiced", "none_voiced",
                                  "shorter_than_window", "no_vad"])
def test_preprocess_is_cmvn_then_voiced_selection(case):
    """One call of ``sliding_cmvn`` with the VAD's destination map equals
    the plain version followed by ``select_voiced_frames``, bit for bit,
    from a read-only view such as an ark gives."""
    t = 120 if case == "shorter_than_window" else 700
    rng = np.random.RandomState(t)
    feats = (rng.randn(t + 1, 23) * 2 + 5).astype(np.float32)[1:]
    feats.setflags(write=False)
    vad = {"all_voiced": np.ones(t, np.float32),
           "none_voiced": np.zeros(t, np.float32),
           "no_vad": None}.get(case, (rng.rand(t) > 0.3).astype(np.float32))
    got = TE.preprocess(feats, cmvn_window=300, vad=vad, device="cpu")
    want = TF.sliding_cmvn_reference(torch.from_numpy(feats.copy()), 300)
    if vad is not None:
        want = torch.from_numpy(TF.select_voiced_frames(want.numpy(), vad))
    assert isinstance(got, torch.Tensor)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    assert got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("fed", ["numpy", "tensor", "mixed"])
def test_extract_iter_takes_arrays_and_tensors_alike(model, fed):
    """The same utterances fed as host arrays, as tensors on the
    extractor's device, or mixed give the same x-vectors;
    ``counters["host_inputs"]`` counts the host arrays it uploaded (not
    the one too short to chunk)."""
    _, _, tp, ts = model
    utts = _utterances()
    on_host = [fed == "numpy" or (fed == "mixed" and i % 2 == 0)
               for i in range(len(utts))]
    stream = [(u, f if host else torch.from_numpy(f))
              for (u, f), host in zip(utts, on_host)]
    ex = TE.XvectorExtractor(port_cfg(CFG), tp, ts,
                             TE.ExtractorConfig(**COMMON), device="cpu")
    got = ex.extract(stream)
    want = TE.XvectorExtractor(port_cfg(CFG), tp, ts,
                               TE.ExtractorConfig(**COMMON), device="cpu"
                               ).extract(utts)
    assert list(got) == list(want)
    for utt in want:
        np.testing.assert_array_equal(got[utt], want[utt])
    assert ex.counters["host_inputs"] == sum(
        host and len(f) >= COMMON["min_chunk"]
        for (_, f), host in zip(utts, on_host))


def test_speaker_means_matches_jax():
    rng = np.random.RandomState(5)
    xv = {f"u{i}": rng.randn(6).astype(np.float32) for i in range(5)}
    u2s = {"u0": "a", "u1": "b", "u2": "a", "u3": "c", "u4": "a"}
    got_m, got_c = TE.speaker_means(xv, u2s)
    want_m, want_c = JE.speaker_means(xv, u2s)
    assert got_c == want_c == {"a": 3, "b": 1, "c": 1}
    for spk in want_m:
        np.testing.assert_array_equal(got_m[spk], want_m[spk])
