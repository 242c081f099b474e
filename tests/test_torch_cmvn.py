"""Sliding CMVN's kernel wrapper (``xvector_tpu_torch/ops/features.py``
``sliding_cmvn``), on the CPU.

A CPU tensor takes the plain version (``sliding_cmvn_reference``, whose
numerics the JAX parity tests in ``tests/test_torch_features.py`` hold),
bit for bit and with no library loaded; a CUDA tensor takes
``csrc/cmvn_sm90.cu``, held to the plain version by the card tests in
``tests/test_torch_cuda.py``."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from xvector_tpu_torch.ops import _build
from xvector_tpu_torch.ops import features as TF

ROOT = Path(__file__).resolve().parent.parent
CASES = [(1, 300), (2, 3), (24, 3), (25, 300), (299, 300), (300, 300),
         (301, 300), (301, 3), (1000, 300), (8526, 300)]


def _feats(t, d, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(t, d, generator=g) + 3.0 * torch.randn(d, generator=g)


@pytest.mark.parametrize("select", [False, True])
@pytest.mark.parametrize("normalize_variance", [False, True])
@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("t,window", CASES)
def test_cpu_call_is_the_plain_version_and_launches_nothing(
        t, window, center, normalize_variance, select, monkeypatch):
    """With ``select``, a destination map from a VAD: the plain version,
    then the boolean selection of the voiced frames."""
    def no_library(*a, **k):
        raise AssertionError("a CPU call loaded the kernel's library")

    monkeypatch.setattr(_build, "load", no_library)
    monkeypatch.setattr(_build, "build", no_library)
    x = _feats(t, 23, t + window)
    want = TF.sliding_cmvn_reference(x, window, center, normalize_variance)
    kw = {}
    if select:
        vad = np.random.RandomState(t).rand(t) > 0.3
        dest, rows = TF.voiced_map(vad.astype(np.float32))
        assert rows == int(vad.sum())
        kw = dict(dest=torch.from_numpy(dest), rows=rows)
        want = want[torch.from_numpy(vad)]
    before = TF.cmvn_launches
    got = TF.sliding_cmvn(x, window, center, normalize_variance, **kw)
    assert TF.cmvn_launches == before == 0
    assert torch.equal(got, want)


@pytest.mark.parametrize("vad,dest,rows", [
    ([0, 1, 1, 0, 1, 0], [-1, 0, 1, -1, 2, -1], 3),
    ([1, 1, 1], [0, 1, 2], 3),
    ([0, 0], [-1, -1], 0),
    ([], [], 0),
    ([0.5, 0.51, 0.2], [-1, 0, -1], 1)])
def test_voiced_map_numbers_the_voiced_frames(vad, dest, rows):
    got, n = TF.voiced_map(np.array(vad, np.float32))
    assert got.dtype == np.int32 and got.tolist() == dest and n == rows


def test_build_sources_list_the_cmvn_kernel():
    assert "cmvn_sm90.cu" in _build.SOURCES
    assert TF.CMVN_SOURCE in _build.SOURCES
    assert (_build.CSRC / TF.CMVN_SOURCE).is_file()


def test_importing_features_loads_no_library():
    code = (
        "import ctypes, torch\n"
        "loaded = []\n"
        "real = ctypes.CDLL\n"
        "ctypes.CDLL = lambda *a, **k: loaded.append(a) or real(*a, **k)\n"
        "from xvector_tpu_torch.ops import _build, features\n"
        "features.sliding_cmvn(torch.randn(400, 23))\n"
        "assert not loaded and not _build._loaded, (loaded, _build._loaded)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
