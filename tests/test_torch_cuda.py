"""Card-only tests of the PyTorch port: the hand-written CUDA kernels
against their plain PyTorch versions, on an NVIDIA GPU.  They skip where
``torch.cuda.is_available()`` is False.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch:

    timeout 900 python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_cuda.py

A phase bug in an mbarrier pipeline hangs rather than fails (the sm90
kernels trap after ~4 s of waiting), so run them under ``timeout``.

Bounds, as max |kernel − plain| / max |plain|: 1e-2 for K1, K2 and K4,
whose outputs are bf16 (both round the same operands to bf16 and
accumulate in f32; a different summation order can flip the bf16 rounding
of an output or an intermediate, nothing more); 1e-3 for K3's f32 output,
where only the order of the f32 sums differs.  Sliding CMVN's kernel is
held to its plain version at 1e-5 · max(1, max |feats|): both take the
same f32 steps, and only an f64 window sum taken in another order can
round to a neighbouring f32 (``tests/test_torch_cmvn.py``).  The wave
front end on the card is held to the CPU at the CPU suite's bounds
(features rtol 1e-4, atol 2e-3; golden fixtures rtol 2e-4, atol 1e-3;
augmentation 1e-4).  The
PLDA back end on the card is held to the CPU and the host f64 back end at
``tests/test_backend.py``'s bounds, with TF32 off and on."""

import os

import numpy as np
import pytest
import torch

from xvector_tpu_torch.extract import extractor as TE
from xvector_tpu_torch.models import tdnn as tt
from xvector_tpu_torch.ops import augment as AUG
from xvector_tpu_torch.ops import conv_bwd as CB
from xvector_tpu_torch.ops import features as FE
from xvector_tpu_torch.ops import tdnn_kernel as TK
from xvector_tpu_torch.train import trainer as TR

BOUND = 1e-2
DW_BOUND = 1e-3
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "feature_golden.npz")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in f32
    return torch.device("cuda")


def _model(name, dev, seed=0):
    cfg = tt.MODEL_ZOO[name]
    return (cfg, *tt.init_params(torch.Generator().manual_seed(seed), cfg,
                                 10, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("t", [5, 333])
@pytest.mark.parametrize("name", ["no_dropout", "prelu", "l2_lrelu",
                                  "tdnn_dilated", "etdnn"])
def test_kernel_matches_plain(name, t, cuda_device):
    cfg, params, state = _model(name, cuda_device)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, t, cfg.feat_dim, generator=g).to(cuda_device)
    mask = torch.ones(3, t)
    mask[1, t * 2 // 3:] = 0.0
    mask = mask.to(cuda_device)
    TK.launches = 0
    got = TK.fused_frame_stack(cfg, params, state, x, mask)
    torch.cuda.synchronize()
    assert TK.launches == cfg.num_frame_layers
    assert got.dtype == torch.float32
    assert got.shape == (3, t, cfg.channels[-1])
    want = TK.fused_frame_stack_reference(cfg, params, state, x, mask)
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= BOUND, err
    assert not got[mask == 0].any()


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    cfg, params, state = _model("tiny", cuda_device)
    x = torch.randn(2, 40, cfg.feat_dim, device=cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        TK.fused_frame_stack(cfg, params, state, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        TK.fused_frame_stack(cfg, params, state,
                             x.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="shape"):
        TK.fused_frame_stack(cfg, params, state, x[..., :5].contiguous())


@pytest.mark.cuda
def test_fused_extraction_matches_unfused(cuda_device):
    cfg, params, state = _model("no_dropout", cuda_device)
    rng = np.random.RandomState(0)
    utts = [(f"u{i}", rng.randn(n, 23).astype(np.float32))
            for i, n in enumerate([30, 300, 1100, 64, 700])]
    out = {}
    for fused in (False, True):
        TK.launches = 0
        ex = TE.XvectorExtractor(cfg, params, state, TE.ExtractorConfig(
            compute_dtype="bfloat16", use_fused=fused, batch_size=2))
        out[fused] = ex.extract(utts)
        assert (TK.launches > 0) == fused
    for utt, _ in utts:
        a, b = out[False][utt], out[True][utt]
        cos = float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))
        assert cos >= 0.999, (utt, cos)


def _waves(lens, seed=0):
    """(B, max) int16 batch of noise bursts with silent gaps, and lens."""
    rng = np.random.RandomState(seed)
    waves = np.zeros((len(lens), max(lens)), np.int16)
    for i, n in enumerate(lens):
        env = np.repeat(rng.rand(-(-n // 800)) > 0.3, 800)[:n]
        waves[i, :n] = np.clip(rng.randn(n) * 3000 * env, -32768, 32767)
    return waves, np.asarray(lens, np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("tf32", [False, True])
def test_front_end_on_card_matches_cpu(cuda_device, tf32):
    """MFCC, VAD and CMVN on the card against the CPU, with TF32 off and
    on: the spectral products run in f64, where TF32 does not reach.
    VAD decisions may differ only where a frame's log energy lies within
    1e-3 of its row's threshold."""
    waves, lens = _waves([64000, 30000, 80000, 1000, 50], seed=1)
    cfg = FE.MfccConfig(dither=0.0)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        out = {}
        for where, dev in (("card", cuda_device), ("cpu", "cpu")):
            feats, mask = FE.mfcc_batch(torch.from_numpy(waves).to(dev),
                                        torch.from_numpy(lens).to(dev), cfg)
            vad = FE.energy_vad_batch(feats, mask)
            cmvn = FE.sliding_cmvn_batch(feats, mask)
            out[where] = [t.cpu() for t in (feats, mask, vad, cmvn)]
        g = np.load(GOLDEN)
        for case in range(3):
            got = FE.mfcc(torch.from_numpy(g[f"wave_{case}"].astype(
                np.float32)).to(cuda_device), cfg).cpu().numpy()
            np.testing.assert_allclose(got, g[f"mfcc_{case}"], rtol=2e-4,
                                       atol=1e-3)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    (fc, mc, vc, cc), (fh, mh, vh, ch) = out["card"], out["cpu"]
    assert torch.equal(mc, mh)
    m = mh.bool()
    np.testing.assert_allclose(fc[m].numpy(), fh[m].numpy(), rtol=1e-4,
                               atol=2e-3)
    np.testing.assert_allclose(cc.numpy(), ch.numpy(), rtol=1e-4, atol=2e-3)
    log_e = fh[..., 0].double()
    mean = (log_e * mh).sum(1, keepdim=True) / mh.sum(1, keepdim=True)
    near = (log_e - (5.5 + 0.5 * mean)).abs() < 1e-3
    assert not ((vc != vh) & ~near).any()


@pytest.mark.cuda
def test_front_end_dither_repeats_on_card(cuda_device):
    """The tail fix's scatter sends duplicate slots to a dummy row, so a
    seeded dithered run repeats bit for bit on the card."""
    waves, lens = _waves([8000, 300, 5000], seed=2)
    w = torch.from_numpy(waves).to(cuda_device)
    n = torch.from_numpy(lens).to(cuda_device)

    def run(seed):
        gen = torch.Generator(device=cuda_device).manual_seed(seed)
        return FE.mfcc_batch(w, n, FE.MfccConfig(), gen)[0]

    a, b, c = run(3), run(3), run(4)
    assert torch.equal(a, b) and bool((a != c).any())


CMVN_T = [1, 2, 24, 25, 299, 300, 301, 1000, 8526, 30000]


def _cmvn_bound(x):
    return 1e-5 * max(1.0, float(np.abs(np.asarray(x, np.float64)).max()))


def _cmvn_feats(t, d, seed):
    """Unit noise plus a per-column offset, which CMVN takes out."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(t, d, generator=g) + 3.0 * torch.randn(d, generator=g)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [300, 3])
@pytest.mark.parametrize("norm_vars", [False, True])
@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("d", [23, 80])
@pytest.mark.parametrize("t", CMVN_T)
def test_sliding_cmvn_kernel_matches_plain(t, d, center, norm_vars, window,
                                           cuda_device):
    x = _cmvn_feats(t, d, 131 * t + d)
    want = FE.sliding_cmvn_reference(x, window, center, norm_vars)
    before = FE.cmvn_launches
    got = FE.sliding_cmvn(x.to(cuda_device), window, center, norm_vars)
    torch.cuda.synchronize()
    assert FE.cmvn_launches == before + 1
    assert got.is_cuda and got.dtype == torch.float32 and got.shape == x.shape
    err = float((got.cpu() - want).abs().max())
    assert err <= _cmvn_bound(x), err


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["float64", "transposed", "strided"])
def test_sliding_cmvn_kernel_takes_other_dtypes_and_layouts(kind,
                                                            cuda_device):
    x = _cmvn_feats(777, 23, 5)
    if kind == "float64":
        x = x.double()
        card = x.to(cuda_device)
    elif kind == "transposed":
        card = x.t().contiguous().to(cuda_device).t()
    else:
        card = torch.stack([x, -x], -1).to(cuda_device)[..., 0]
    assert torch.equal(card.cpu(), x)
    assert kind == "float64" or not card.is_contiguous()
    before = FE.cmvn_launches
    got = FE.sliding_cmvn(card, 300)
    torch.cuda.synchronize()
    assert FE.cmvn_launches == before + 1
    assert got.dtype == x.dtype and got.shape == x.shape
    err = float((got.cpu() - FE.sliding_cmvn_reference(x, 300)).abs().max())
    assert err <= _cmvn_bound(x), err


@pytest.mark.cuda
@pytest.mark.parametrize("voiced", ["random", "one"])
@pytest.mark.parametrize("t", [40, 1000, 8526, 30000])
def test_sliding_cmvn_kernel_selects_by_its_map(t, voiced, cuda_device):
    """CMVN and voiced-frame selection in one launch: the rows the map
    keeps equal the plain version's boolean selection within the CMVN
    bound, down to a map that drops every frame but one."""
    x = _cmvn_feats(t, 23, 7 * t + 1)
    if voiced == "random":
        vad = (np.random.default_rng(t).random(t) > 0.26).astype(np.float32)
    else:
        vad = np.zeros(t, np.float32)
        vad[t // 3] = 1.0
    dest, rows = FE.voiced_map(vad)
    want = FE.sliding_cmvn_reference(x, 300)[torch.from_numpy(vad > 0.5)]
    before = FE.cmvn_launches
    got = FE.sliding_cmvn(x.to(cuda_device), 300,
                          dest=torch.from_numpy(dest).to(cuda_device),
                          rows=rows)
    torch.cuda.synchronize()
    assert FE.cmvn_launches == before + 1
    assert got.is_cuda and got.dtype == torch.float32
    assert got.shape == want.shape == (rows, 23)
    err = float((got.cpu() - want).abs().max())
    assert err <= _cmvn_bound(x), err


@pytest.mark.cuda
def test_preprocess_on_card_takes_the_kernel_once_a_call(cuda_device):
    """One launch a call, none for an utterance with no voiced frame; the
    rows stay on the card."""
    rng = np.random.default_rng(3)
    before = FE.cmvn_launches
    sizes = (40, 1000, 8526)
    for n in sizes:
        feats = (rng.standard_normal((n, 23))
                 + 3.0 * rng.standard_normal(23)).astype(np.float32)
        feats.setflags(write=False)            # as an ark's view
        vad = (rng.random(n) > 0.3).astype(np.float32)
        got = TE.preprocess(feats, vad=vad, device=cuda_device)
        assert got.is_cuda and got.dtype == torch.float32
        want = TE.preprocess(feats, vad=vad, device="cpu")
        assert got.shape == want.shape == (int((vad > 0.5).sum()), 23)
        assert float((got.cpu() - want).abs().max()) <= _cmvn_bound(feats)
    assert FE.cmvn_launches == before + len(sizes)
    none = TE.preprocess(feats, vad=np.zeros(len(feats), np.float32),
                         device=cuda_device)
    assert none.is_cuda and none.shape == (0, 23)
    assert FE.cmvn_launches == before + len(sizes)


@pytest.mark.cuda
def test_extract_iter_on_card_tensors_uploads_nothing(cuda_device):
    """``preprocess``'s rows go through ``extract_iter`` without an upload
    (``host_inputs`` 0), to the same x-vectors as the same rows fed as
    host arrays."""
    cfg, params, state = _model("no_dropout", cuda_device)
    rng = np.random.default_rng(4)
    utts = []
    for i, n in enumerate((300, 1200, 60, 2500, 700)):
        feats = (rng.standard_normal((n, 23))
                 + 3.0 * rng.standard_normal(23)).astype(np.float32)
        vad = (rng.random(n) > 0.3).astype(np.float32)
        utts.append((f"u{i}", TE.preprocess(feats, vad=vad,
                                            device=cuda_device)))
    ecfg = TE.ExtractorConfig(min_chunk=25, max_chunk=1000, batch_size=2,
                              compute_dtype="bfloat16", use_fused=True)
    on_card = TE.XvectorExtractor(cfg, params, state, ecfg,
                                  device=cuda_device)
    got = on_card.extract(utts)
    assert on_card.counters["host_inputs"] == 0
    from_host = TE.XvectorExtractor(cfg, params, state, ecfg,
                                    device=cuda_device)
    want = from_host.extract([(u, f.cpu().numpy()) for u, f in utts])
    assert from_host.counters["host_inputs"] == len(utts)
    assert list(got) == list(want) == [u for u, _ in utts]
    for u in want:
        np.testing.assert_array_equal(got[u], want[u])


@pytest.mark.cuda
def test_sliding_cmvn_kernel_rejects_what_it_does_not_take(cuda_device,
                                                           monkeypatch):
    x = torch.randn(10, 23, device=cuda_device)
    before = FE.cmvn_launches
    with pytest.raises(ValueError, match="T, D"):
        FE.sliding_cmvn(x[None], 300)
    with pytest.raises(ValueError, match=">= 1"):
        FE.sliding_cmvn(x, 0)
    invalid = 1   # cudaErrorInvalidValue
    # a window whose rows overflow a block's shared memory (232,448 bytes
    # on sm_90: 58,112 f32 rows): the C function refuses it, the wrapper
    # raises
    with pytest.raises(RuntimeError, match=f"cudaError {invalid}"):
        FE.sliding_cmvn(torch.zeros(60000, 1, device=cuda_device), 60000)
    # the C function refuses a window geometry off its terms, unlaunched
    lib = FE._cmvn_lib()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    for win, off, rows in ((11, 5, 10), (10, 10, 10), (0, 0, 10),
                           (4, -1, 10), (4, 1, 9)):
        # (4, 1, 9): without a map every frame is a row
        assert lib.sliding_cmvn_launch(x.data_ptr(), None, out.data_ptr(),
                                       10, 23, win, off, rows, 0,
                                       stream) == invalid
    # a launch the C function reports failed raises and is not counted

    class Refused:
        @staticmethod
        def sliding_cmvn_launch(*args):
            return invalid

    monkeypatch.setattr(FE, "_cmvn_lib", lambda: Refused)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        FE.sliding_cmvn(x, 300)
    assert FE.cmvn_launches == before


@pytest.mark.cuda
def test_wave_extractor_fused_matches_unfused(cuda_device):
    """bf16 wave extraction with K1 (the layer-0 kernel, v5 on layers 1-4,
    no v4 launch) against the unfused frame stack on the same weights."""
    cfg, params, state = _model("no_dropout", cuda_device)
    rng = np.random.RandomState(5)
    utts = [(f"u{i}", _waves([n], seed=10 + i)[0][0].astype(np.float32))
            for i, n in enumerate([8000, 20000, 64000, 3000, 40000])]
    utts.append(("silence", np.zeros(8000, np.float32)))
    utts.append(("long", rng.randn(90000).astype(np.float32) * 2000))
    out = {}
    for fused in (False, True):
        TK.launches = 0
        for name in TK.route_launches:
            TK.route_launches[name] = 0
        ex = TE.WaveExtractor(cfg, params, state, TE.WaveExtractorConfig(
            batch_size=2, max_chunk=800, use_fused=fused),
            device=cuda_device)
        out[fused] = ex.extract(utts)
        if fused:
            calls = TK.route_launches["l0_sm90"]
            assert calls > 0 and TK.route_launches["sm90"] == 4 * calls
            assert TK.route_launches["sm80"] == 0
        else:
            assert TK.launches == 0
    assert set(out[True]) == set(out[False]) == {u for u, _ in utts
                                                 if u != "silence"}
    for utt, a in out[False].items():
        b = out[True][utt]
        cos = float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))
        assert cos >= 0.999, (utt, cos)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["reverb", "noise", "music", "babble"])
def test_augment_on_card_matches_cpu(cuda_device, kind):
    rng = np.random.RandomState(6)
    x = (rng.randn(16000) * 1000).astype(np.float32)
    assets = dict(rirs=[(np.exp(-np.arange(4000) / 800)
                         * rng.randn(4000)).astype(np.float32)],
                  noises=[rng.randn(5000).astype(np.float32)],
                  musics=[rng.randn(30000).astype(np.float32)],
                  speeches=[rng.randn(9000).astype(np.float32)
                            for _ in range(8)])
    got = AUG.augment_utterance(kind, x, np.random.RandomState(1),
                                AUG.AugmentConfig(), device=cuda_device,
                                **assets)
    want = AUG.augment_utterance(kind, x, np.random.RandomState(1),
                                 AUG.AugmentConfig(), device="cpu", **assets)
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-4


def _err(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def _conv_inputs(b, t, cin, cout, k, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, t, cin, generator=g).to(dev, torch.bfloat16),
            (0.05 * torch.randn(k, cin, cout, generator=g)).to(
                dev, torch.bfloat16),
            torch.randn(b, t, cout, generator=g).to(dev, torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("k,d,b,t,cin,cout", [
    (5, 1, 3, 37, 64, 64),        # one tile column, ragged T
    (7, 1, 2, 301, 384, 640),     # C off the 128 tile, T off 16
    (3, 4, 5, 7, 24, 40),         # rows shorter than the taps' reach
    (3, 2, 6, 301, 12, 20),       # C % 8 != 0: scalar loads
    (5, 1, 1, 1, 16, 8),          # a single frame
])
def test_conv_kernels_match_plain(k, d, b, t, cin, cout, cuda_device):
    x, w, g = _conv_inputs(b, t, cin, cout, k, cuda_device)
    before = dict(CB.launches)
    routes = dict(CB.route_launches)
    y, dx, dw = CB.conv_fwd(x, w, d), CB.conv_dx(g, w, d), \
        CB.conv_dw(x, g, k, d)
    torch.cuda.synchronize()
    assert {n: CB.launches[n] - before[n] for n in before} == \
        {"fwd": 1, "dw": 1, "dx": 1}
    design = CB.route(x.shape, w.shape, d)
    assert _routes_delta(routes) == {"fwd_" + design: 1, "dx_" + design: 1,
                                     "dw_" + design: 1}
    assert (y.dtype, dx.dtype, dw.dtype) == (torch.bfloat16, torch.bfloat16,
                                             torch.float32)
    assert _err(y, CB.conv_fwd_reference(x, w, d)) <= BOUND
    assert _err(dx, CB.conv_dx_reference(g, w, d)) <= BOUND
    assert _err(dw, CB.conv_dw_reference(x, g, k, d)) <= DW_BOUND


def _routes_delta(before):
    return {n: CB.route_launches[n] - before[n] for n in before
            if CB.route_launches[n] != before[n]}


@pytest.mark.cuda
@pytest.mark.parametrize("k,d,b,t,cin,cout", [
    (3, 1, 1, 64, 64, 64),        # one tile: brings up the descriptors
    (5, 1, 64, 304, 512, 512),    # the training shapes
    (7, 1, 64, 304, 512, 512),
    (5, 1, 6, 301, 384, 640),     # ragged B, T, and C off the tiles
    (7, 1, 6, 301, 640, 384),
    (3, 4, 8, 300, 512, 512),     # dilated
    (5, 1, 3, 37, 40, 512),       # Cin = 40 (feat_dim 40 front layer)
])
def test_conv_sm90_kernels_match_plain(k, d, b, t, cin, cout, cuda_device):
    """K3 v2 and K4 v2 (the "sm90" route) against the plain versions."""
    assert CB.route((b, t, cin), (k, cin, cout), d) == "sm90"
    x, w, g = _conv_inputs(b, t, cin, cout, k, cuda_device)
    before = dict(CB.route_launches)
    dx, dw = CB.conv_dx(g, w, d), CB.conv_dw(x, g, k, d)
    torch.cuda.synchronize()
    assert _routes_delta(before) == {"dx_sm90": 1, "dw_sm90": 1}
    assert (dx.dtype, dw.dtype) == (torch.bfloat16, torch.float32)
    assert _err(dx, CB.conv_dx_reference(g, w, d)) <= BOUND
    assert _err(dw, CB.conv_dw_reference(x, g, k, d)) <= DW_BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("k,d,b,t,cin,cout", [
    (3, 1, 1, 64, 64, 64),        # one tile: brings up the descriptors
    (5, 1, 64, 304, 512, 512),    # the training shapes
    (7, 1, 64, 304, 512, 512),
    (5, 1, 6, 301, 384, 640),     # ragged B, T, and C off the tiles
    (7, 1, 6, 301, 640, 384),
    (3, 2, 8, 300, 512, 512),     # dilated
    (3, 3, 8, 300, 512, 512),
    (3, 4, 8, 300, 512, 512),
    (5, 1, 3, 37, 40, 512),       # Cin = 40 (feat_dim 40 front layer)
])
def test_conv_fwd_sm90_matches_plain(k, d, b, t, cin, cout, cuda_device):
    """K2 v2 (the "sm90" route, csrc/fwd_sm90.cu) and K2 v1 forced through
    design="sm80" against the plain version."""
    assert CB.route((b, t, cin), (k, cin, cout), d) == "sm90"
    x, w, _ = _conv_inputs(b, t, cin, cout, k, cuda_device)
    before = dict(CB.route_launches)
    y, y1 = CB.conv_fwd(x, w, d), CB.conv_fwd(x, w, d, design="sm80")
    torch.cuda.synchronize()
    assert _routes_delta(before) == {"fwd_sm90": 1, "fwd_sm80": 1}
    want = CB.conv_fwd_reference(x, w, d)
    assert y.dtype == y1.dtype == torch.bfloat16
    assert y.shape == (b, t, cout)
    assert _err(y, want) <= BOUND
    assert _err(y1, want) <= BOUND


@pytest.mark.cuda
def test_conv_function_routes_every_call_to_sm90(cuda_device):
    """One forward and backward of the autograd Function at a wide shape:
    K2, K3 and K4 each run once, all on the "sm90" route."""
    x, w, g = _conv_inputs(4, 45, 128, 96, 5, cuda_device, seed=2)
    xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    before = dict(CB.route_launches)
    CB.conv1d_same_fused_bwd(xs, ws, 1).backward(g)
    torch.cuda.synchronize()
    assert _routes_delta(before) == {"fwd_sm90": 1, "dw_sm90": 1,
                                     "dx_sm90": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("name,b,t", [("no_dropout", 32, 777),
                                      ("prelu", 3, 333), ("etdnn", 3, 333),
                                      ("tiny", 2, 50)])
def test_kernel_routes_layers_by_rule(name, b, t, cuda_device):
    """Each layer on the design layer_route gives it (the layer-0 kernel,
    then K1 v5; no v4), the same through design="sm90", and K1 v4 on every
    layer through design="sm80"."""
    cfg, params, state = _model(name, cuda_device, seed=4)
    g = torch.Generator().manual_seed(5)
    x = torch.randn(b, t, cfg.feat_dim, generator=g).to(cuda_device)
    mask = torch.ones(b, t)
    mask[-1, t // 2:] = 0.0
    mask = mask.to(cuda_device)
    cins = (cfg.feat_dim,) + cfg.channels[:-1]
    rule = [TK.layer_route(l, c, o, k) for l, (c, o, k) in
            enumerate(zip(cins, cfg.channels, cfg.kernel_sizes))]
    assert "sm80" not in rule
    want = TK.fused_frame_stack_reference(cfg, params, state, x, mask)
    for design, designs in ((None, rule), ("sm90", rule),
                            ("sm80", ["sm80"] * len(rule))):
        before = dict(TK.route_launches)
        got = TK.fused_frame_stack(cfg, params, state, x, mask,
                                   design=design)
        torch.cuda.synchronize()
        assert {n: TK.route_launches[n] - before[n] for n in before} == {
            n: designs.count(n) for n in ("l0_sm90", "sm90", "sm80")}
        assert got.dtype == torch.float32
        assert got.shape == want.shape
        assert float((got - want).abs().max() / want.abs().max()) <= BOUND
        assert not got[mask == 0].any()


def _layer_err(got, want, mask):
    """Normalised error of a layer's kernel output against its plain
    version, over the columns the kernel writes; masked rows must be
    exact zeros."""
    want = want[..., :got.shape[-1]]
    assert not got[mask == 0].any()
    return float((got.float() - want).abs().max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("feat", [23, 40])
def test_layer_zero_kernel_matches_plain(feat, cuda_device):
    """The layer-0 kernel at 32x1024 against l0_reference (the packed
    plain form), with masked tails that end inside a 128-frame tile."""
    from dataclasses import replace
    cfg = replace(tt.MODEL_ZOO["no_dropout"], feat_dim=feat)
    params, state = tt.init_params(torch.Generator().manual_seed(6), cfg,
                                   10, device=cuda_device)
    folded = TK.fold_stack(cfg, params, state)
    g = torch.Generator().manual_seed(7)
    x = torch.randn(32, 1024, feat, generator=g).to(cuda_device)
    lens = torch.randint(300, 1025, (32,), generator=g)
    mask = (torch.arange(1024)[None] < lens[:, None]).float().to(cuda_device)
    before = dict(TK.route_launches)
    got = TK.fused_layer(cfg, folded, 0, x, mask)
    torch.cuda.synchronize()
    assert TK.route_launches["l0_sm90"] == before["l0_sm90"] + 1
    assert got.dtype == torch.bfloat16 and got.shape == (32, 1024, 512)
    want = TK.l0_reference(cfg, folded, x, mask)
    assert _layer_err(got, want, mask) <= BOUND


@pytest.mark.cuda
def test_etdnn_padded_last_layer_matches_plain(cuda_device):
    """etdnn's 512 -> 1500 layer on K1 v5 with W and the vectors padded to
    1504 columns and an f32 output of 1500, at 32x1024."""
    cfg, params, state = _model("etdnn", cuda_device, seed=8)
    folded = TK.fold_stack(cfg, params, state)
    assert folded.layers[9][0].shape == (1, 512, 1504)
    g = torch.Generator().manual_seed(9)
    h = torch.randn(32, 1024, 512, generator=g).to(cuda_device,
                                                   torch.bfloat16)
    mask = torch.ones(32, 1024)
    mask[3, 700:] = 0.0
    mask = mask.to(cuda_device)
    before = dict(TK.route_launches)
    got = TK.fused_layer(cfg, folded, 9, h, mask)
    torch.cuda.synchronize()
    assert TK.route_launches["sm90"] == before["sm90"] + 1
    assert got.dtype == torch.float32 and got.shape == (32, 1024, 1500)
    assert got.is_contiguous()
    want = TK.layer_reference(cfg, folded, 9, h, mask)
    assert _layer_err(got, want, mask) <= BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["no_dropout", "etdnn"])
def test_default_route_launches_no_v4(name, cuda_device):
    """fused_frame_stack's default route and a fold made once: one launch
    of the layer-0 kernel and v5 on every later layer, none of K1 v4."""
    cfg, params, state = _model(name, cuda_device, seed=10)
    folded = TK.fold_stack(cfg, params, state)
    x = torch.randn(4, 300, cfg.feat_dim, device=cuda_device)
    mask = torch.ones(4, 300, device=cuda_device)
    before = dict(TK.route_launches)
    got = TK.fused_frame_stack(cfg, folded, None, x, mask)
    torch.cuda.synchronize()
    assert {n: TK.route_launches[n] - before[n] for n in before} == {
        "l0_sm90": 1, "sm90": cfg.num_frame_layers - 1, "sm80": 0}
    want = TK.fused_frame_stack_reference(cfg, params, state, x, mask)
    assert float((got - want).abs().max() / want.abs().max()) <= BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("k", [5, 7])
def test_conv_dw_sm90_same_bits_on_every_call(k, cuda_device):
    """K3 v2 sums the cluster's partials in rank order: no atomics, so two
    calls on the same inputs give the same bits."""
    x, _, g = _conv_inputs(64, 304, 512, 512, k, cuda_device, seed=3)
    a = CB.conv_dw(x, g, k, 1)
    b = CB.conv_dw(x, g, k, 1)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_conv_function_grads_match_autograd_of_plain(cuda_device):
    k, d = 5, 1
    x, w, g = _conv_inputs(4, 45, 128, 96, k, cuda_device, seed=1)
    xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    CB.conv1d_same_fused_bwd(xs, ws, d).backward(g)
    xr, wr = x.float().requires_grad_(True), w.float().requires_grad_(True)
    CB.conv_fwd_reference(xr, wr, d).backward(g.float())
    assert xs.grad.dtype == ws.grad.dtype == torch.bfloat16
    assert _err(xs.grad, xr.grad) <= BOUND
    assert _err(ws.grad, wr.grad) <= BOUND


@pytest.mark.cuda
def test_conv_kernels_reject_what_they_do_not_take(cuda_device):
    x, w, g = _conv_inputs(2, 40, 16, 16, 3, cuda_device)
    with pytest.raises(ValueError, match="do not take"):
        CB.conv_fwd(x.float(), w.float(), 1)
    with pytest.raises(ValueError, match="contiguous"):
        CB.conv_fwd(x.transpose(0, 1).contiguous().transpose(0, 1), w, 1)
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.empty(x.numel() + 1, dtype=torch.bfloat16,
                           device=cuda_device)
        CB.conv_dx(flat[1:].view(2, 40, 16), w, 1)
    with pytest.raises(ValueError, match="shape"):
        CB.conv_dw(x, g[:, :20].contiguous(), 3, 1)


@pytest.mark.cuda
def test_tiny_train_step_launch_counts(cuda_device, tmp_path):
    """tiny's layer 2 (k=7, 32 channels: k·Cin = 224 > 160) is its one
    wide layer: one K2, one K3 and one K4 call per step, K3 and K4 on the
    "sm90" route."""
    tr = TR.Trainer(TR.TrainConfig(model="tiny", num_targets=5,
                                   compute_dtype="bfloat16"), str(tmp_path))
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(4, 40, 23).astype(np.float16)).to(
        cuda_device)
    y = torch.from_numpy(rng.randint(0, 5, 4).astype(np.int32)).to(
        cuda_device)
    for name in CB.launches:
        CB.launches[name] = 0
    routes = dict(CB.route_launches)
    _, m = tr._step_fn(tr.params, tr.optimizer, tr.state, x, y, 33, 4, 1e-3,
                       1.0, 1.0, torch.Generator(cuda_device))
    torch.cuda.synchronize()
    assert CB.launches == {"fwd": 1, "dw": 1, "dx": 1}
    assert _routes_delta(routes) == {"fwd_sm90": 1, "dw_sm90": 1,
                                     "dx_sm90": 1}
    assert np.isfinite(float(m["loss"]))


# ---------------------------------------------------------------------------
# the train → checkpoint → extract slice on the card
# ---------------------------------------------------------------------------

def _learnable(n, seed, b=8, t=48, classes=5):
    rng = np.random.RandomState(seed)
    means = np.random.RandomState(0).randn(classes, 23) * 2
    out = []
    for _ in range(n):
        y = rng.randint(0, classes, b).astype(np.int32)
        x = (rng.randn(b, t, 23) * 0.3 + means[y][:, None, :])
        out.append((x.astype(np.float16), y, t))
    return out


def _card_trainer(path, **kw):
    cfg = TR.TrainConfig(model="tiny", num_targets=5, compute_dtype="bfloat16",
                         block_size=2, num_epochs=1, **kw)
    return TR.Trainer(cfg, str(path))


def _all_tensors(tr):
    from xvector_tpu_torch.models.convert import tree_leaves
    out = [t.detach().cpu() for t in tree_leaves(tr.params)]
    out += [t.cpu() for t in tree_leaves(tr.state)]
    for st in tr.optimizer.state_dict()["state"].values():
        out += [torch.as_tensor(v).cpu() for v in st.values()]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_checkpoint_round_trip_on_card_is_bit_exact(cuda_device, tmp_path,
                                                    moments):
    """save_iteration → restore_into on the card gives the same params, BN
    state and Adam state, and one more iteration from each gives the same
    bits."""
    from xvector_tpu_torch.train import checkpoints as C
    mbs = _learnable(3, 1)
    a = _card_trainer(tmp_path / "a", adam_moments_dtype=moments)
    a.train_one_iteration(0, iter(mbs), 1e-3, 0.0, 1.0)
    C.save_iteration(a, 1)
    b = _card_trainer(tmp_path / "b", adam_moments_dtype=moments)
    C.restore_into(b, C.iteration_path(a.work_dir, 1))
    assert all(torch.equal(x, y) for x, y in zip(_all_tensors(a),
                                                 _all_tensors(b)))
    for tr in (a, b):
        tr.train_one_iteration(1, iter(mbs), 1e-3, 0.0, 1.0)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(_all_tensors(a),
                                                 _all_tensors(b)))


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_attention_pooling_bf16_on_card_matches_cpu_f32(cuda_device, masked):
    g = torch.Generator().manual_seed(3)
    h = torch.randn(4, 300, 64, generator=g)
    att = {"w": 0.1 * torch.randn(32, 32, generator=g),
           "b": 0.1 * torch.randn(32, generator=g),
           "v": 0.1 * torch.randn(32, generator=g)}
    mask = torch.ones(4, 300, 1)
    if masked:
        mask[1, 200:] = 0.0
        mask[3, 50:] = 0.0
    want = tt.attention_pooling(h, att, mask)
    got = tt.attention_pooling(
        h.to(cuda_device, torch.bfloat16),
        {k: v.to(cuda_device) for k, v in att.items()}, mask.to(cuda_device))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _err(got.cpu(), want) <= 5e-2


@pytest.mark.cuda
def test_am_softmax_on_card_matches_cpu(cuda_device):
    from xvector_tpu_torch.models import heads as TH
    g = torch.Generator().manual_seed(4)
    hidden = torch.randn(64, 512, generator=g)
    w = torch.randn(512, 300, generator=g)
    labels = torch.randint(0, 300, (64,), generator=g)
    out = {}
    for dev in ("cpu", cuda_device):
        h = hidden.to(dev, copy=True).requires_grad_(True)
        ww = w.to(dev, copy=True).requires_grad_(True)
        loss, logits = TH.am_softmax(h, ww, labels.to(dev))
        (loss + logits.square().mean() * 1e-3).backward()
        out[str(dev)] = [loss.detach().cpu(), logits.detach().cpu(),
                         h.grad.cpu(), ww.grad.cpu()]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert _err(a.reshape(-1), b.reshape(-1)) <= 1e-4


@pytest.mark.cuda
def test_train_stop_check_resume_is_bit_identical_on_card(cuda_device,
                                                          tmp_path):
    """A 3-iteration Trainer.train on the card, stopped by its stop_check
    after the first iteration and resumed, ends with the bits of an
    uninterrupted run (K3 v2 sums in a fixed order; nothing on the path
    uses atomics)."""
    from xvector_tpu_torch.train.preemption import GracefulPreemption
    archives = [_learnable(3, s) for s in (1, 2, 3)]
    ref = _card_trainer(tmp_path / "ref", optimizer="adam")
    assert ref.train(lambda i: iter(archives[i]), 3) == 3
    pre = GracefulPreemption()

    def loader(i):
        def gen():
            yield from archives[i]
            pre.trigger()            # at the boundary after iteration 0
        return gen()

    stopped = _card_trainer(tmp_path / "run", optimizer="adam")
    assert stopped.train(loader, 3, preemption=pre) == 1
    resumed = _card_trainer(tmp_path / "run", optimizer="adam")
    assert resumed.train(lambda i: iter(archives[i]), 3) == 3
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(_all_tensors(resumed),
                                                 _all_tensors(ref)))


def _plda_workload(seed=0, n_spk=400, dim=40):
    """Speakers with 2..8 utterances (the unique-count grouping), a trial
    grid with 1- and 3-utterance enrolment models."""
    rng = np.random.RandomState(seed)
    spk = {f"s{s}": rng.randn(dim) * 1.5 + rng.randn(2 + s % 7, dim)
           for s in range(n_spk)}
    enroll = {f"e{i}": rng.randn(dim) * 1.5 for i in range(30)}
    test = {f"t{j}": rng.randn(dim) * 1.5 for j in range(70)}
    trials = [(e, t) for t in test for e in enroll]
    num_utts = {e: 1 + 2 * (i % 2) for i, e in enumerate(enroll)}
    return spk, enroll, test, trials, num_utts


@pytest.mark.cuda
@pytest.mark.parametrize("tf32", [False, True])
def test_plda_device_on_card_matches_cpu_and_host(cuda_device, tf32):
    """The device EM and scorer on the card against the same functions on
    the CPU and the host f64 back end, at tests/test_backend.py's bounds
    (EM: sorted psi rtol 5e-3, atol 5e-4, LLRs 2e-2 x span; scoring 1e-3 x
    span; projection 2e-4).  With TF32 allowed by the caller, the card's
    numbers equal the TF32-off run bit for bit and the caller's setting
    survives each call."""
    from xvector_tpu_torch.backend import plda as BP
    from xvector_tpu_torch.backend import plda_device as PD
    spk, enroll, test, trials, num_utts = _plda_workload()
    card = PD.train_plda_device(spk, device=cuda_device)
    scores = PD.score_trials_device(card, enroll, test, trials, num_utts,
                                    device=cuda_device)
    if tf32:
        before = (torch.backends.cuda.matmul.allow_tf32,
                  torch.get_float32_matmul_precision())
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        try:
            on = PD.train_plda_device(spk, device=cuda_device)
            assert torch.backends.cuda.matmul.allow_tf32
            on_scores = PD.score_trials_device(on, enroll, test, trials,
                                               num_utts, device=cuda_device)
            assert torch.get_float32_matmul_precision() == "high"
        finally:
            torch.backends.cuda.matmul.allow_tf32 = before[0]
            torch.set_float32_matmul_precision(before[1])
        for f in ("mean", "transform", "psi"):
            np.testing.assert_array_equal(getattr(on, f), getattr(card, f))
        np.testing.assert_array_equal(on_scores, scores)
    cpu = PD.train_plda_device(spk, device="cpu")
    host = BP.train_plda(spk)
    for other in (cpu, host):
        np.testing.assert_allclose(np.sort(card.psi), np.sort(other.psi),
                                   rtol=5e-3, atol=5e-4)
    want = host.score_trials(enroll, test, trials, num_utts)
    span = want.max() - want.min()
    np.testing.assert_allclose(card.score_trials(enroll, test, trials,
                                                 num_utts), want,
                               atol=2e-2 * span)
    card_on_host = PD.score_trials_device(host, enroll, test, trials,
                                          num_utts, device=cuda_device)
    np.testing.assert_allclose(card_on_host, want, atol=1e-3 * span)
    np.testing.assert_allclose(
        card_on_host, PD.score_trials_device(host, enroll, test, trials,
                                             num_utts, device="cpu"),
        atol=1e-3 * span)
    v = np.stack(list(test.values()))
    for kw in ({}, {"simple_length_norm": True}):
        np.testing.assert_allclose(
            PD.project_device(host, v, device=cuda_device, **kw).cpu(),
            host.project(v, **kw), rtol=2e-4, atol=2e-4)


def _recipe_corpus(num_spk=5, utts=4, seed=0):
    """Resonant-tone speakers (tests/test_e2e.py's generator)."""
    rng = np.random.RandomState(seed)
    f0 = rng.uniform(300, 3000, size=(num_spk, 2))
    waves, utt2spk = {}, {}
    for s in range(num_spk):
        for u in range(utts):
            n = int(8000 * rng.uniform(1.8, 2.5))
            t = np.arange(n) / 8000
            w = sum(np.sin(2 * np.pi * f * t + rng.uniform(0, 6))
                    for f in f0[s])
            waves[f"spk{s}_utt{u}"] = (3000 * w + 300 * rng.randn(n)).astype(
                np.float32)
            utt2spk[f"spk{s}_utt{u}"] = f"spk{s}"
    return waves, utt2spk


@pytest.mark.cuda
def test_tiny_recipe_on_card_matches_cpu(cuda_device, tmp_path):
    """The recipe's stages 1-4 at ``tiny`` width in f32 on the card and on
    the CPU, dither off: features within the CPU suite's bounds, VAD and
    the egs plans equal (archive labels, lengths and shapes), archive
    values at most one float16 step apart beyond CMVN's f32 round-off, a
    falling loss on the card, and the card's extraction of its own model
    equal to the CPU's extraction of the same weights (1e-3 normalised)."""
    from xvector_tpu_torch.cli import run as RUN
    from xvector_tpu_torch.data import allocator as AL
    from xvector_tpu_torch.data import archives as AR
    from xvector_tpu_torch.io import kaldi_ark as kio
    from xvector_tpu_torch.io.datadir import DataDir
    from xvector_tpu_torch.models.convert import tree_map

    waves, utt2spk = _recipe_corpus()
    out = {}
    for dev in ("cpu", "cuda"):
        recipe = RUN.Recipe(RUN.RecipeConfig(
            str(tmp_path / dev), min_utt_frames=60, num_valid_utts=4,
            num_archives=2, compress_feats=False, device=dev,
            allocator=AL.AllocatorConfig(min_frames=60, max_frames=120,
                                         minibatch_size=8, num_repeats=3,
                                         frames_per_iter=20_000, seed=1),
            train=TR.TrainConfig(model="tiny", num_targets=1, num_epochs=2,
                                 compute_dtype="float32")))
        feat = recipe.make_features(DataDir(utt2spk=utt2spk),
                                    waves.__getitem__, "all",
                                    dither_seed=None)
        recipe.make_egs(feat)
        out[dev] = (recipe, feat)
    (cpu, cfeat), (card, gfeat) = out["cpu"], out["cuda"]
    for utt in utt2spk:
        np.testing.assert_allclose(kio.read_mat(gfeat.feats[utt]),
                                   kio.read_mat(cfeat.feats[utt]),
                                   rtol=1e-4, atol=2e-3)
        np.testing.assert_array_equal(kio.read_vec_flt(gfeat.vad[utt]),
                                      kio.read_vec_flt(cfeat.vad[utt]))
    for name in ("egs.0.xta", "egs.1.xta", "valid_egs.xta"):
        got = list(AR.ArchiveReader(card._p(name)))
        want = list(AR.ArchiveReader(cpu._p(name)))
        assert len(got) == len(want) > 0
        for (xa, ya, ta), (xb, yb, tb) in zip(got, want):
            assert xa.shape == xb.shape and ta == tb
            np.testing.assert_array_equal(ya, yb)
            step = np.spacing(np.maximum(np.abs(xa), np.abs(xb)))
            assert np.all(np.abs(xa.astype(np.float32)
                                 - xb.astype(np.float32))
                          <= step.astype(np.float32) + 1e-5)
    trainer = card.train(len(set(utt2spk.values())))
    import json
    with open(os.path.join(trainer.work_dir, "metrics.jsonl")) as f:
        train = [r for r in map(json.loads, f) if r["kind"] == "train"]
    assert train[-1]["loss"] < train[0]["loss"]
    got = card.extract(trainer, gfeat, "all")
    host = type("T", (), {})()
    host.model_cfg = trainer.model_cfg
    host.params = tree_map(lambda t: t.detach().cpu(), trainer.params)
    host.state = tree_map(lambda t: t.detach().cpu(), trainer.state)
    want = cpu.extract(host, gfeat, "card_weights")
    assert set(got) == set(want) and len(got) == len(utt2spk)
    for utt in want:
        err = np.abs(got[utt] - want[utt]).max() / np.abs(want[utt]).max()
        assert err <= 1e-3, (utt, err)


def _sre16_tree(root, rng):
    """A small LDC tree for run_sre16 (tests/test_torch_run_sre16.py's
    layout): SWBD cellular 1 calls of 10 speakers (two-channel PCM
    SPHERE), a pre-built SRE data dir of 10 speakers, the SRE16 eval tree
    of 4 models in tgl and yue with its evaluation key beside it, and 8
    unlabeled majors."""
    def sph(x):
        x = x[:, None] if x.ndim == 1 else x
        head = (f"NIST_1A\n   1024\nsample_count -i {x.shape[0]}\n"
                f"channel_count -i {x.shape[1]}\nsample_rate -i 8000\n"
                "sample_n_bytes -i 2\nsample_byte_format -s2 10\n"
                "sample_coding -s3 pcm\nend_head\n")
        return head.encode().ljust(1024, b" ") + x.astype(">i2").tobytes()

    def wave(spk, secs=3.0):
        t = np.arange(int(8000 * secs)) / 8000
        return np.clip(2500 * np.sin(2 * np.pi * (300 + spk * 137 % 2800) * t)
                       + 1500 * np.sin(2 * np.pi * (400 + spk * 211 % 2500)
                                       * t + 1.0)
                       + 150 * rng.randn(len(t)), -32000, 32000)

    def put(rel, data):
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        (path.write_bytes if isinstance(data, bytes) else path.write_text)(
            data)
        return path

    calls = []
    for c in range(5):
        for rep in range(3):
            put(f"swbd/data/audio/sw_4{c}{rep:02d}.sph", sph(np.stack(
                [wave(2 * c), wave(2 * c + 1)], 1)))
            calls.append(f"4{c}{rep:02d},{1000 + 2 * c},{1001 + 2 * c},M,F")
    put("swbd/doc/swb_callstats.tbl", "\n".join(calls) + "\n")
    u2s, scp = [], []
    for s in range(10):
        for u in range(3):
            path = put(f"sre/audio/sre{s}_{u}.sph", sph(wave(200 + s)))
            u2s.append(f"sre{s}_{u} srespk{s}")
            scp.append(f"sre{s}_{u} {path}")
    put("sre/utt2spk", "\n".join(u2s) + "\n")
    put("sre/wav.scp", "\n".join(scp) + "\n")
    enroll, subj, segcall, langs, trials = (
        ["modelid\tsegmentid"], ["segmentid\tsubjectid"],
        ["segmentid callid"], [], ["modelid segmentid side targettype"])
    for m in range(4):
        for u in range(2):
            put(f"eval/data/enrollment/en{m}{u}.sph", sph(wave(100 + m)))
            enroll.append(f"model{m}\ten{m}{u}")
            put(f"eval/data/test/te{m}{u}.sph", sph(wave(100 + m, 1.7)))
            subj.append(f"te{m}{u}\tsubj{m}")
            segcall.append(f"te{m}{u} call{m}{u}")
            langs.append(f"call{m}{u} {('tgl', 'yue')[m % 2]}")
            trials += [f"model{k} te{m}{u} a "
                       + ("target" if k == m else "nontarget")
                       for k in range(4)]
        put(f"major/data/unlabeled/major/mj{m}.sph", sph(wave(100 + m)))
        put(f"major/data/unlabeled/major/mk{m}.sph", sph(wave(300 + m)))
    put("eval/docs/sre16_eval_enrollment.tsv", "\n".join(enroll) + "\n")
    put("eval/docs/sre16_eval_segment_key.tsv", "\n".join(subj) + "\n")
    key = "download/sre16_evaluation_key"
    put(f"{key}/docs/sre16_eval_segment_key.tsv", "\n".join(segcall) + "\n")
    put(f"{key}/metadata/calls.tsv", "\n".join(langs) + "\n")
    put(f"{key}/docs/sre16_eval_trial_key.tsv", "\n".join(trials) + "\n")


@pytest.mark.cuda
def test_run_sre16_tiny_on_card_takes_sm90_designs(cuda_device, tmp_path):
    """``run_sre16.main`` at ``tiny`` width in bf16 on the card: training
    through K2-K4 (tiny's one wide layer: one call of each per step, all
    "sm90"), extraction through K1 (the layer-0 kernel, v5 on layers 1-4) in
    the waveform route and, after ``--stage 7``, the feature-ark route;
    both variants scored per language."""
    import json
    from xvector_tpu_torch.cli import run_sre16

    _sre16_tree(tmp_path / "ldc", np.random.RandomState(0))
    work = tmp_path / "exp"
    ldc = tmp_path / "ldc"
    argv = ["--work-dir", str(work), "--device", "cuda",
            "--swbd-cell1-root", str(ldc / "swbd"),
            "--sre-data-dir", str(ldc / "sre"),
            "--sre16-eval-root", str(ldc / "eval"),
            "--sre16-major-root", str(ldc / "major"),
            "--model", "tiny", "--num-epochs", "1",
            "--frames-per-iter", "25000", "--min-chunk", "40",
            "--max-chunk", "80", "--min-utt-frames", "39",
            "--min-spk-utts", "2", "--minibatch-size", "8",
            "--num-repeats", "4", "--compute-dtype", "bfloat16",
            "--lda-dim", "8"]
    for stage, extra in ((None, ["--extract-from-wav"]), (7, [])):
        routes, k1 = dict(CB.route_launches), dict(TK.route_launches)
        res = run_sre16.main(argv + extra + (["--stage", "7"] if stage
                                             else []))
        conv = _routes_delta(routes)
        k1 = {d: TK.route_launches[d] - k1[d] for d in k1}
        assert set(res) == {"out_of_domain", "adapted"}
        for r in res.values():
            assert r["num_trials"] == 32
            assert set(r["per_condition"]) == {"tgl", "yue"}
            assert np.isfinite(r["scores"]).all()
        assert k1["sm90"] == 4 * k1["l0_sm90"] > 0 and k1["sm80"] == 0
        if stage is None:
            with open(work / "exp" / "metrics.jsonl") as f:
                steps = sum(int(r["minibatches"]) for r in map(json.loads, f)
                            if r["kind"] == "train")
            assert steps > 0 and conv == {"fwd_sm90": steps,
                                          "dw_sm90": steps,
                                          "dx_sm90": steps}
        else:
            assert not any(conv.values())      # the model is kept


# ---------------------------------------------------------------------------
# several gloo ranks sharing the card
# ---------------------------------------------------------------------------

def _tiny_weights(classes, seed=0):
    from xvector_tpu_torch.models.convert import params_to_numpy
    return params_to_numpy(*tt.init_params(
        torch.Generator().manual_seed(seed), tt.MODEL_ZOO["tiny"], classes,
        device="cpu"))


def _one_rank_step(weights, batches, path, **fields):
    """One process's SGD iteration on the card from the same weights."""
    from xvector_tpu_torch.models.convert import params_from_numpy, tree_leaves
    cfg = TR.TrainConfig(**{**dict(model="tiny", num_targets=8,
                                   compute_dtype="float32", block_size=2,
                                   optimizer="sgd", momentum=0.5), **fields})
    tr = TR.Trainer(cfg, str(path))
    tr._place_all(*params_from_numpy(*weights, device="cpu"))
    st = tr.train_one_iteration(0, iter(batches), lr=1e-3, dropout=0.0,
                                shrink=1.0)
    return st["loss"], [p.detach().cpu() for p in tree_leaves(tr.params)]


@pytest.mark.cuda
def test_two_gloo_ranks_share_the_card_for_a_bf16_step(cuda_device,
                                                       tmp_path):
    """Two gloo ranks on cuda:0, one bf16 SGD step through K2-K4 on each
    rank's rows, against one process on the whole batch: chip_smoke.py's
    phase 15 part 2 at tiny width (loss 1e-2 relative, per-parameter
    update cosine >= 0.98), every rank's K2-K4 calls on sm90 (tiny's one
    wide layer: one call each)."""
    import torch_dist_workers as W
    weights = _tiny_weights(8)
    batches = W.scaling_batches(n=1, mb=8, t=48)
    res = W.run("cuda_step", 2, {"tiny": weights, "work": str(tmp_path),
                                 "device": "cuda:0", "batches": batches},
                tmp_path)
    for a, b in zip(res[0]["params"], res[1]["params"]):
        assert torch.equal(a, b)                 # the same bits on each rank
    loss, one = _one_rank_step(weights, batches, tmp_path / "one",
                               compute_dtype="bfloat16")
    assert abs(res[0]["loss"] - loss) / abs(loss) < 1e-2
    from xvector_tpu_torch.models.convert import tree_leaves
    before = [torch.from_numpy(a) for a in tree_leaves(weights[0])]
    for a, b, w in zip(res[0]["params"], one, before):
        cos = torch.nn.functional.cosine_similarity(
            (a - w).double().flatten(), (b - w).double().flatten(), dim=0)
        assert cos >= 0.98
    want = {"fwd_sm90": 1, "dw_sm90": 1, "dx_sm90": 1, "fwd_sm80": 0,
            "dw_sm80": 0, "dx_sm80": 0}
    assert all(r["routes"] == want for r in res)


@pytest.mark.cuda
def test_sharded_head_on_three_ranks_of_the_card(cuda_device, tmp_path):
    """``head="sharded_softmax"`` over three gloo ranks on cuda:0 (9
    classes, 3 columns each): one f32 SGD step equals one process's dense
    softmax step at 1e-5."""
    import torch_dist_workers as W
    weights = _tiny_weights(9)
    batches = W.scaling_batches(n=1, mb=8, t=48)
    batches = [(x, y % 9, t) for x, y, t in batches]
    res = W.run("cuda_sharded", 3, {"tiny": weights, "work": str(tmp_path),
                                    "device": "cuda:0", "batches": batches,
                                    "num_targets": 9}, tmp_path)
    loss, one = _one_rank_step(weights, batches, tmp_path / "one",
                               num_targets=9)
    for r in res:
        assert abs(r["loss"] - loss) <= 1e-5 * abs(loss)
        for a, b in zip(r["params"], one):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
