"""The port's h5 weight export and import (``xvector_tpu_torch/utils/
export.py``) against the JAX package's, and the extraction CLI's
``--reference-h5``.  Weights cross exactly (float32 in, float32 out); the
CLI's rows from an h5 equal its rows from the same model's checkpoint."""

import jax
import numpy as np
import pytest
import torch

from xvector_tpu.models import tdnn as jt
from xvector_tpu.utils import export as JX
from xvector_tpu_torch.cli import extract_embedding
from xvector_tpu_torch.io import kaldi_ark as kio
from xvector_tpu_torch.models import tdnn as tt
from xvector_tpu_torch.models.convert import params_from_numpy, tree_leaves
from xvector_tpu_torch.train import checkpoints as C
from xvector_tpu_torch.train import trainer as TR
from xvector_tpu_torch.utils import export as TX

h5py = pytest.importorskip("h5py")


def _jax_model(name, seed, classes=5):
    cfg = jt.MODEL_ZOO[name]
    p, s = jt.init_params(jax.random.PRNGKey(seed), cfg, classes)
    p, s = jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s)
    # BN statistics away from their 0/1 init, so a dropped one shows
    for st in s["frame"] + s["embed"]:
        st["mean"] = st["mean"] + 0.25
        st["var"] = st["var"] * 1.5
    return cfg, p, s


def _flat(tree, prefix=""):
    """{path: numpy leaf} of a nest of dicts and lists."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, f"{prefix}/{i}").items()}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu().numpy()
    return {prefix: np.asarray(tree)}


def _assert_trees_equal(port, ref):
    a, b = _flat(port), _flat(ref)
    assert sorted(a) == sorted(b)
    for k in b:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_h5_round_trip_across_packages(tmp_path):
    cfg, p, s = _jax_model("tiny", 0)
    tp, ts = params_from_numpy(p, s, device="cpu")
    TX.export_h5(str(tmp_path / "port.h5"), tp, ts)
    jp, js = JX.import_h5(str(tmp_path / "port.h5"), p, s)
    _assert_trees_equal(tp, jp)
    _assert_trees_equal(ts, js)
    JX.export_h5(str(tmp_path / "jax.h5"), p, s)
    with h5py.File(tmp_path / "jax.h5") as a, \
            h5py.File(tmp_path / "port.h5") as b:
        names = []
        a.visit(names.append)
        other = []
        b.visit(other.append)
        assert names == other
    back_p, back_s = TX.import_h5(str(tmp_path / "jax.h5"), tp, ts)
    assert all(isinstance(x, torch.Tensor) for x in tree_leaves(back_p))
    _assert_trees_equal(back_p, p)
    _assert_trees_equal(back_s, s)
    only_p, none = TX.import_h5(str(tmp_path / "jax.h5"), tp)
    assert none is None
    _assert_trees_equal(only_p, p)


@pytest.mark.parametrize("name", ["tiny", "prelu", "l2_lrelu_attention"])
def test_reference_h5_round_trip_across_packages(tmp_path, name):
    cfg, p, s = _jax_model(name, 1)
    tcfg = tt.MODEL_ZOO[name]
    tp, ts = params_from_numpy(p, s, device="cpu")
    want = JX.reference_named_weights(cfg, p, s)
    got = TX.reference_named_weights(tcfg, tp, ts)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])

    JX.export_reference_h5(str(tmp_path / "jax.h5"), cfg, p, s)
    ip, is_ = TX.import_reference_h5(str(tmp_path / "jax.h5"), tcfg, 5,
                                     device="cpu")
    _assert_trees_equal(ip, p)
    _assert_trees_equal(is_, s)

    TX.export_reference_h5(str(tmp_path / "port.h5"), tcfg, tp, ts)
    jp, js = JX.import_reference_h5(str(tmp_path / "port.h5"), cfg, 5)
    _assert_trees_equal(tp, jp)
    _assert_trees_equal(ts, js)


def test_reference_h5_missing_bn_stats_fall_back_to_init(tmp_path):
    cfg, p, s = _jax_model("prelu", 2)
    path = str(tmp_path / "model.h5")
    JX.export_reference_h5(path, cfg, p, s)
    with h5py.File(path, "a") as f:
        del f["frame_level_info_layer-0/mean:0"]
        del f["frame_level_info_layer-0/variance:0"]
        del f["embed_layer-1/variance:0"]
    tcfg = tt.MODEL_ZOO["prelu"]
    tp, ts = TX.import_reference_h5(path, tcfg, 5, device="cpu")
    jp, js = JX.import_reference_h5(path, cfg, 5)
    _assert_trees_equal(tp, jp)
    _assert_trees_equal(ts, js)
    c0 = tcfg.channels[0]
    assert torch.equal(ts["frame"][0]["mean"], torch.zeros(c0))
    assert torch.equal(ts["frame"][0]["var"], torch.ones(c0))
    assert torch.equal(ts["embed"][1]["var"], torch.ones(tcfg.embed_dims[1]))
    np.testing.assert_array_equal(ts["embed"][1]["mean"].numpy(),
                                  s["embed"][1]["mean"])
    np.testing.assert_array_equal(tp["frame"][1]["alpha"].numpy(),
                                  p["frame"][1]["alpha"])


def test_reference_h5_errors_match_jax(tmp_path):
    cfg, p, s = _jax_model("tiny", 3)
    path = str(tmp_path / "model.h5")
    JX.export_reference_h5(path, cfg, p, s)
    with pytest.raises(ValueError, match="preset"):
        JX.import_reference_h5(path, jt.MODEL_ZOO["no_dropout"], 5)
    with pytest.raises(ValueError, match="preset"):
        TX.import_reference_h5(path, tt.MODEL_ZOO["no_dropout"], 5,
                               device="cpu")
    with pytest.raises(ValueError, match="preset"):
        TX.import_reference_h5(path, tt.MODEL_ZOO["tiny"], 7, device="cpu")
    with h5py.File(path, "a") as f:
        del f["output/b:0"]
    with pytest.raises(KeyError, match="output/b"):
        TX.import_reference_h5(path, tt.MODEL_ZOO["tiny"], 5, device="cpu")


def test_cli_reference_h5_rows_equal_model_dir_rows(tmp_path):
    tr = TR.Trainer(TR.TrainConfig(model="tiny", num_targets=4,
                                   random_seed=6), str(tmp_path / "exp"),
                    device="cpu")
    C.save_iteration(tr, 0)
    h5 = str(tmp_path / "model.h5")
    TX.export_reference_h5(h5, tr.model_cfg, tr.params, tr.state)
    rng = np.random.RandomState(7)
    feats = str(tmp_path / "feats.ark")
    with kio.ArkWriter(feats) as w:
        for i, n in enumerate((90, 140, 33)):
            w.write(f"u{i}", rng.randn(n, 23).astype(np.float32))
    rows = {}
    for src in (f"--model-dir={tmp_path / 'exp'}", f"--reference-h5={h5}"):
        out = str(tmp_path / f"xv{len(rows)}.ark")
        extract_embedding.main([
            src, "--model=tiny", "--num-targets=4",
            f"--feats-rspecifier=ark:{feats}", f"--output-ark={out}",
            "--compute-dtype=float32", "--device=cpu"])
        rows[src.split("=")[0]] = dict(kio.read_vec_flt_scp(
            out.replace(".ark", ".scp")))
    a, b = rows["--model-dir"], rows["--reference-h5"]
    assert sorted(a) == sorted(b) == ["u0", "u1", "u2"]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(SystemExit, match="exactly one"):
        extract_embedding.main([
            f"--model-dir={tmp_path / 'exp'}", f"--reference-h5={h5}",
            "--model=tiny", "--num-targets=4",
            f"--feats-rspecifier=ark:{feats}",
            f"--output-ark={tmp_path / 'x.ark'}", "--device=cpu"])
