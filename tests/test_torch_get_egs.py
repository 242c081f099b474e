"""The port's get_egs CLI (xvector_tpu_torch.cli.get_egs): the JAX
package's flags plus ``--device``, the same egs directory contract
(``egs.N.xta``, ``valid_egs.xta``, ``train_subset_egs.xta``, ``pdf2num``,
``egs_info.json``, ``info/``), archives byte-identical to the recipe's
``make_egs`` under the same settings, the same outputs as the JAX
package's CLI on the same data dir, and ``train_dnn --egs-dir`` training
from them, all through the port's CLIs on the CPU."""

import argparse
import contextlib
import io
import os

import numpy as np
import pytest

from xvector_tpu.cli import get_egs as JG
from xvector_tpu.runtime import native as JN
from xvector_tpu_torch.cli import get_egs as PG
from xvector_tpu_torch.cli import run as PR
from xvector_tpu_torch.cli import train_dnn
from xvector_tpu_torch.data import allocator as PA
from xvector_tpu_torch.data import archives as PAR
from xvector_tpu_torch.io.datadir import DataDir

SR = 8000
CMVN_ATOL = 1e-5   # f32 sliding CMVN, the port's against the JAX package's
FLAGS = ["--min-frames-per-chunk=60", "--max-frames-per-chunk=120",
         "--minibatch-size=8", "--num-repeats=3", "--frames-per-iter=20000",
         "--num-train-archives=2", "--num-heldout-utts=3",
         "--min-utt-frames=59", "--min-spk-utts=2", "--random-seed=11"]


def _quiet(fn, *a):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        fn(*a)
    return out.getvalue()


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """Stage 1's data dir (feats.scp, vad.scp, utt2spk) of 5 speakers × 4
    resonant-tone utterances, written by the port's recipe on the CPU."""
    tmp = tmp_path_factory.mktemp("get_egs")
    rng = np.random.RandomState(1)
    waves, utt2spk = {}, {}
    for s in range(5):
        f = rng.uniform(300, 3000, size=2)
        for u in range(4):
            n = int(SR * rng.uniform(1.8, 2.4))
            t = np.arange(n) / SR
            w = sum(np.sin(2 * np.pi * fi * t + rng.uniform(0, 6))
                    for fi in f)
            waves[f"spk{s}_u{u}"] = (3000 * w + 300 * rng.randn(n)).astype(
                np.float32)
            utt2spk[f"spk{s}_u{u}"] = f"spk{s}"
    recipe = PR.Recipe(PR.RecipeConfig(str(tmp / "feat"), device="cpu"))
    feat = recipe.make_features(DataDir(utt2spk=utt2spk),
                                waves.__getitem__, split="all",
                                dither_seed=None)
    feat.save(str(tmp / "data"))
    return tmp, str(tmp / "data")


def _options(parser_fn):
    """Every option string of a get_args parser, with its default."""
    captured = {}
    real = argparse.ArgumentParser.parse_args

    def grab(self, argv=None, namespace=None):
        captured["p"] = self
        return real(self, ["data", "egs"])
    argparse.ArgumentParser.parse_args = grab
    try:
        parser_fn([])
    finally:
        argparse.ArgumentParser.parse_args = real
    return {o: a.default for a in captured["p"]._actions
            for o in a.option_strings}


def test_same_flags_as_jax_plus_device():
    port, jax_ = _options(PG.get_args), _options(JG.get_args)
    assert set(port) - set(jax_) == {"--device"}
    assert set(jax_) <= set(port)
    for opt, default in jax_.items():
        assert port[opt] == default, opt
    assert port["--device"] == "cuda"


def test_get_egs_writes_the_contract_and_train_dnn_trains(data_dir):
    tmp, data = data_dir
    egs = str(tmp / "egs")
    out = _quiet(PG.main, FLAGS + ["--device=cpu", data, egs])
    assert "wrote 2 archives, 5 targets" in out
    for name in ("egs.0.xta", "egs.1.xta", "valid_egs.xta",
                 "train_subset_egs.xta", "pdf2num", "egs_info.json"):
        assert os.path.exists(os.path.join(egs, name)), name
    info = {n: open(os.path.join(egs, "info", n)).read().strip()
            for n in ("feat_dim", "num_archives", "num_targets")}
    assert info == {"feat_dim": "23", "num_archives": "2",
                    "num_targets": "5"}
    with PAR.ArchiveReader(os.path.join(egs, "egs.0.xta")) as r:
        x, y, t = r.read(0)
        assert x.shape[0] == 8 and x.shape[2] == 23 and 60 <= t <= 120
        assert set(y) <= set(range(5))
    exp = str(tmp / "exp")
    _quiet(train_dnn.main, [
        "--model=tiny", "--num-targets=5", "--num-epochs=1",
        "--compute-dtype=float32", f"--egs-dir={egs}", f"--dir={exp}",
        "--block-size=2", "--device=cpu"])
    assert os.path.exists(os.path.join(exp, "model_final"))
    assert os.path.exists(os.path.join(exp, "model_2", "done"))


def test_get_egs_equals_make_egs_byte_for_byte(data_dir):
    """The CLI and the recipe's stage 2 write the same archives."""
    tmp, data = data_dir
    egs = str(tmp / "egs_cli")
    _quiet(PG.main, FLAGS + ["--device=cpu", data, egs])
    recipe = PR.Recipe(PR.RecipeConfig(
        str(tmp / "egs_recipe"), device="cpu", num_archives=2,
        num_valid_utts=3, min_utt_frames=59, min_spk_utts=2,
        allocator=PA.AllocatorConfig(min_frames=60, max_frames=120,
                                     minibatch_size=8, num_repeats=3,
                                     frames_per_iter=20_000, seed=11)))
    from xvector_tpu_torch.io.datadir import load_data_dir
    _quiet(recipe.make_egs, load_data_dir(data))
    for name in ("egs.0.xta", "egs.1.xta", "valid_egs.xta",
                 "train_subset_egs.xta", "pdf2num", "egs_info.json"):
        assert (open(os.path.join(egs, name), "rb").read()
                == open(recipe._p(name), "rb").read()), name


def test_get_egs_matches_jax_cli(data_dir, monkeypatch):
    """The JAX package's CLI on the same data dir (on its Python data
    path): equal pdf2num, egs_info.json and info/, and archives with the
    same shapes, labels and lengths, one float16 step apart at most
    beyond CMVN's f32 round-off."""
    tmp, data = data_dir
    monkeypatch.setattr(JN, "available", lambda: False)
    monkeypatch.setattr(JN, "get_lib", lambda: None)
    port, jax_ = str(tmp / "egs_p"), str(tmp / "egs_j")
    _quiet(PG.main, FLAGS + ["--device=cpu", data, port])
    _quiet(JG.main, FLAGS + [data, jax_])
    for name in ("pdf2num", "egs_info.json", "info/feat_dim",
                 "info/num_archives", "info/num_targets"):
        assert (open(os.path.join(port, name)).read()
                == open(os.path.join(jax_, name)).read()), name
    for name in ("egs.0.xta", "egs.1.xta", "valid_egs.xta",
                 "train_subset_egs.xta"):
        got = list(PAR.ArchiveReader(os.path.join(port, name)))
        want = list(PAR.ArchiveReader(os.path.join(jax_, name)))
        assert len(got) == len(want) > 0
        for (xa, ya, ta), (xb, yb, tb) in zip(got, want):
            assert xa.shape == xb.shape and ta == tb
            np.testing.assert_array_equal(ya, yb)
            step = np.spacing(np.maximum(np.abs(xa), np.abs(xb)))
            assert np.all(np.abs(xa.astype(np.float32)
                                 - xb.astype(np.float32))
                          <= step.astype(np.float32) + CMVN_ATOL)
