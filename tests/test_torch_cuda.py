"""Card-only tests of the PyTorch port: the hand-written CUDA kernel against
its plain PyTorch version, on an NVIDIA GPU.  They skip where
``torch.cuda.is_available()`` is False.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Bound for K1: max |kernel − plain| / max |plain| ≤ 1e-2 (both round the
same operands to bf16 and accumulate in f32; a different summation order
can flip the bf16 rounding of an intermediate, nothing more)."""

import numpy as np
import pytest
import torch

from xvector_tpu_torch.extract import extractor as TE
from xvector_tpu_torch.models import tdnn as tt
from xvector_tpu_torch.ops import tdnn_kernel as TK

BOUND = 1e-2


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
