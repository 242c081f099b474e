"""Port's CLIs (``xvector_tpu_torch.cli``): train_dnn → eval_dnn →
extract_embedding over a tiny egs dir on the CPU (``--device=cpu``),
mirroring ``tests/test_cli.py``.  The extracted x-vectors are held to an
in-process extractor over the restored checkpoint (identical) and to the
JAX package's ``extract_xvector`` on the same numpy weights (f32, 1e-4,
the model forward's bound)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xvector_tpu.models import tdnn as jt
from xvector_tpu_torch.cli import eval_dnn, extract_embedding, train_dnn
from xvector_tpu_torch.data import archives as AR
from xvector_tpu_torch.data.reference_tar import write_reference_tar
from xvector_tpu_torch.extract import extractor as TE
from xvector_tpu_torch.io import kaldi_ark as kio
from xvector_tpu_torch.models.convert import params_to_numpy
from xvector_tpu_torch.train import checkpoints as C
from xvector_tpu_torch.train.trainer import TrainConfig, Trainer

NUM_SPK = 4


def _make_egs(d, n_archives=2):
    rng = np.random.RandomState(0)
    means = rng.randn(NUM_SPK, 23) * 2

    def mb():
        y = rng.randint(0, NUM_SPK, 8).astype(np.int32)
        x = (rng.randn(8, 64, 23) * 0.3
             + means[y][:, None, :]).astype(np.float16)
        return x, y, 64

    for a in range(n_archives):
        AR.write_archive(str(d / f"egs.{a}.xta"), [mb() for _ in range(3)])
    AR.write_archive(str(d / "valid_egs.xta"), [mb()])


def _train(tmp_path, *extra):
    egs = tmp_path / "egs"
    egs.mkdir()
    _make_egs(egs)
    work = str(tmp_path / "exp")
    train_dnn.main([
        "--tf-model-class=ModelWithoutDropout", "--model=tiny",
        f"--num-targets={NUM_SPK}", "--num-epochs=1",
        "--compute-dtype=float32", "--initial-effective-lrate=0.002",
        "--final-effective-lrate=0.0005", f"--egs-dir={egs}",
        f"--dir={work}", "--block-size=2", "--device=cpu", *extra])
    return egs, work


def _feats_ark(path, n=5, seed=1):
    rng = np.random.RandomState(seed)
    utts = {f"utt{i}": rng.randn(80 + 10 * i, 23).astype(np.float32)
            for i in range(n)}
    with kio.ArkWriter(path, path + ".scp") as w:
        for k, v in utts.items():
            w.write(k, v)
    return utts


def test_train_eval_extract_cli(tmp_path, capsys):
    egs, work = _train(tmp_path)
    assert os.readlink(os.path.join(work, "model_final")) == "model_2"
    report = open(os.path.join(work, "accuracy.report")).read()
    assert "valid_loss" in report.splitlines()[0]
    assert len(report.splitlines()) == 3             # header + 2 iterations
    capsys.readouterr()

    eval_dnn.main([f"--model-dir={work}", "--model=tiny",
                   f"--num-targets={NUM_SPK}", f"--egs={egs}/valid_egs.xta",
                   "--device=cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert 0.0 <= out["accuracy"] <= 1.0 and out["loss"] > 0.0
    # the last valid record of the run evaluated the same model
    recs = [json.loads(l) for l in open(os.path.join(work, "metrics.jsonl"))]
    [last] = [r for r in recs if r.get("kind") == "valid"
              and r["iteration"] == 1]
    np.testing.assert_allclose(out["loss"], last["loss"], rtol=1e-6)

    feats_ark = str(tmp_path / "feats.ark")
    utts = _feats_ark(feats_ark)
    spk2utt = tmp_path / "spk2utt"
    spk2utt.write_text("sA utt0 utt1 utt2\nsB utt3\n")
    out_ark = str(tmp_path / "xvector.ark")
    args = [f"--model-dir={work}", "--model=tiny",
            f"--num-targets={NUM_SPK}", f"--feats-rspecifier=ark:{feats_ark}",
            f"--output-ark={out_ark}", "--batch-size=4",
            "--min-chunk-size=25", "--chunk-size=100",
            "--compute-dtype=float32", f"--spk2utt={spk2utt}",
            "--device=cpu"]
    extract_embedding.main(args)
    xv = dict(kio.read_vec_flt_scp(out_ark.replace(".ark", ".scp")))
    assert set(xv) == set(utts) and all(v.shape == (64,)
                                        for v in xv.values())

    # the same as an extractor over the restored checkpoint ...
    tr = Trainer(TrainConfig(model="tiny", num_targets=NUM_SPK),
                 str(tmp_path / "probe"), device="cpu")
    C.restore_into(tr, os.path.realpath(os.path.join(work, "model_final")))
    ex = TE.XvectorExtractor(tr.model_cfg, tr.params, tr.state,
                             TE.ExtractorConfig(min_chunk=25, max_chunk=100,
                                                batch_size=4),
                             device="cpu")
    want = ex.extract(utts.items())
    for k in utts:
        np.testing.assert_array_equal(xv[k], want[k])
    # ... and as the JAX model on the same weights (utt1 is one 90-frame
    # chunk)
    jp, js = params_to_numpy(tr.params, tr.state)
    ref = np.asarray(jt.extract_xvector(jt.MODEL_ZOO["tiny"], jp, js,
                                        jnp.asarray(utts["utt1"][None])))[0]
    np.testing.assert_allclose(xv["utt1"], ref, rtol=1e-4, atol=1e-4)

    spk = dict(kio.read_vec_flt_scp(out_ark.replace(".ark", "_spk.scp")))
    assert set(spk) == {"sA", "sB"}
    np.testing.assert_allclose(
        spk["sA"], np.mean([xv["utt0"], xv["utt1"], xv["utt2"]], axis=0),
        atol=1e-6)
    num_utts = dict(l.split() for l in
                    open(out_ark.replace(".ark", "_num_utts.ark")))
    assert num_utts == {"sA": "3", "sB": "1"}

    # idempotent restart: the second call must skip without reading
    capsys.readouterr()
    extract_embedding.main([a if not a.startswith("--feats") else
                            "--feats-rspecifier=ark:/nonexistent.ark"
                            for a in args])
    assert "skipping" in capsys.readouterr().out


def test_train_cli_rejects_unknown_model(tmp_path):
    with pytest.raises(SystemExit):
        train_dnn.main(["--model=bogus", "--num-targets=4",
                        f"--egs-dir={tmp_path}", f"--dir={tmp_path}/x",
                        "--device=cpu"])


def test_extract_cli_accepts_model0_only_dir(tmp_path):
    """A run that crashed in iteration 0 leaves only model_0; extraction
    uses it."""
    tr = Trainer(TrainConfig(model="tiny", num_targets=NUM_SPK,
                             compute_dtype="float32"),
                 str(tmp_path / "m0only"), device="cpu")
    C.save_iteration(tr, 0)
    feats_ark = str(tmp_path / "f.ark")
    _feats_ark(feats_ark, n=1)
    out_ark = str(tmp_path / "xv.ark")
    extract_embedding.main([
        f"--model-dir={tmp_path / 'm0only'}", "--model=tiny",
        f"--num-targets={NUM_SPK}", f"--feats-rspecifier=ark:{feats_ark}",
        f"--output-ark={out_ark}", "--device=cpu"])
    assert len(dict(kio.read_vec_flt_scp(out_ark.replace(".ark",
                                                          ".scp")))) == 1
    with pytest.raises(SystemExit, match="no checkpoint"):
        extract_embedding.main([
            f"--model-dir={tmp_path / 'empty'}", "--model=tiny",
            f"--num-targets={NUM_SPK}", f"--feats-rspecifier=ark:{feats_ark}",
            f"--output-ark={tmp_path / 'other.ark'}", "--device=cpu"])


@pytest.mark.parametrize("flag,item", [("--reference-h5=model.h5", "A5")])
def test_extract_cli_names_what_is_not_ported(tmp_path, flag, item):
    """``flag`` (ROADMAP ``item``) is ported now: given beside --model-dir
    the CLI names the conflict, not a missing port.  Its own behaviour is
    held in tests/test_torch_export.py."""
    with pytest.raises(SystemExit,
                       match="exactly one of --model-dir/--reference-h5"):
        extract_embedding.main([f"--model-dir={tmp_path}", "--model=tiny",
                                f"--num-targets={NUM_SPK}", flag,
                                f"--output-ark={tmp_path / 'xv.ark'}",
                                "--device=cpu"])


def test_extract_cli_shards_cover_every_utterance(tmp_path):
    _, work = _train(tmp_path)
    feats_ark = str(tmp_path / "feats.ark")
    utts = _feats_ark(feats_ark, n=5)
    got = {}
    for shard in (0, 1):
        out_ark = str(tmp_path / f"xv{shard}.ark")
        extract_embedding.main([
            f"--model-dir={work}", "--model=tiny",
            f"--num-targets={NUM_SPK}", f"--feats-rspecifier=ark:{feats_ark}",
            f"--output-ark={out_ark}", "--num-shards=2", f"--shard={shard}",
            "--device=cpu"])
        part = dict(kio.read_vec_flt_scp(out_ark.replace(".ark", ".scp")))
        assert not set(part) & set(got)
        got.update(part)
    assert set(got) == set(utts)


def test_eval_cli_reads_reference_tar(tmp_path, capsys):
    egs, work = _train(tmp_path)
    with AR.ArchiveReader(str(egs / "valid_egs.xta")) as r:
        mbs = list(r)
    write_reference_tar(str(tmp_path / "valid.tar"),
                        [(f, l) for f, l, _ in mbs])
    capsys.readouterr()
    out = []
    for egs_path in (str(egs / "valid_egs.xta"), str(tmp_path / "valid.tar")):
        eval_dnn.main([f"--model-dir={work}/model_2", "--model=tiny",
                       f"--num-targets={NUM_SPK}", f"--egs={egs_path}",
                       "--device=cpu"])
        out.append(json.loads(capsys.readouterr().out.strip()))
    assert out[0]["loss"] == out[1]["loss"]
    assert out[0]["accuracy"] == out[1]["accuracy"]


@pytest.mark.parametrize("cli", ["train_dnn", "eval_dnn",
                                 "extract_embedding"])
def test_clis_refuse_missing_cuda(tmp_path, monkeypatch, cli):
    """--device defaults to cuda, and a CLI without a card raises instead
    of running on the CPU."""
    egs, work = _train(tmp_path)
    feats_ark = str(tmp_path / "feats.ark")
    _feats_ark(feats_ark, n=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {
        "train_dnn": (train_dnn, ["--model=tiny", f"--num-targets={NUM_SPK}",
                                  f"--egs-dir={egs}",
                                  f"--dir={tmp_path / 'again'}"]),
        "eval_dnn": (eval_dnn, [f"--model-dir={work}", "--model=tiny",
                                f"--num-targets={NUM_SPK}",
                                f"--egs={egs}/valid_egs.xta"]),
        "extract_embedding": (extract_embedding, [
            f"--model-dir={work}", "--model=tiny",
            f"--num-targets={NUM_SPK}",
            f"--feats-rspecifier=ark:{feats_ark}",
            f"--output-ark={tmp_path / 'xv.ark'}"]),
    }
    module, args = argv[cli]
    with pytest.raises(RuntimeError, match="cuda"):
        module.main(args)
