"""Package rules of the PyTorch port: it never imports JAX or the JAX
package, its entry points refuse to fall back to the CPU silently, and
parameters cross between the packages' numpy form exactly."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from xvector_tpu.models import tdnn as jt
from xvector_tpu_torch.backend import plda as BP
from xvector_tpu_torch.backend import plda_device as PD
from xvector_tpu_torch.bench import adam_mu as BA
from xvector_tpu_torch.bench import dense as BD
from xvector_tpu_torch.bench import extract_sweep as BX
from xvector_tpu_torch.bench import headline as BH
from xvector_tpu_torch.bench import scale_sre16 as BS
from xvector_tpu_torch.cli import extract_embedding, get_egs, run_sre16
from xvector_tpu_torch.cli import run as RUN
from xvector_tpu_torch.extract import extractor as TE
from xvector_tpu_torch.models import tdnn as tt
from xvector_tpu_torch.models.convert import (params_from_numpy,
                                              params_to_numpy)
from xvector_tpu_torch.ops import augment as AUG
from xvector_tpu_torch.ops import conv_bwd as CB
from xvector_tpu_torch.train import checkpoints as C
from xvector_tpu_torch.train import trainer as TR
from xvector_tpu_torch.utils import export as EX

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "xvector_tpu_torch"
# the package's sources; _build/ holds what a build or a run produced
SOURCES = sorted(p for p in PKG.rglob("*.py")
                 if "_build" not in p.relative_to(PKG).parts)


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in SOURCES)


def test_importing_every_module_leaves_jax_out():
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'xvector_tpu' or "
            "m.startswith('xvector_tpu.'))\n"
            "print(repr(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*SOURCES, ROOT / "chip_smoke.py"]))
def test_no_jax_import_in_source(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "xvector_tpu", "flax",
                               "optax"), f"{path}:{node.lineno} imports {name}"


@pytest.mark.parametrize("entry", ["init_params", "params_from_numpy",
                                   "extractor", "preprocess", "Trainer",
                                   "conv1d_same_fused_bwd", "WaveExtractor",
                                   "make_wave_to_xvector",
                                   "augment_utterance", "cli_wav",
                                   "project_device", "score_matrix",
                                   "score_trials_device",
                                   "train_plda_device", "Recipe",
                                   "import_reference_h5", "cli_h5",
                                   "cli_run", "cli_get_egs",
                                   "cli_run_sre16",
                                   "bench_measure_train_step",
                                   "bench_extract_sweep", "bench_dense",
                                   "bench_adam_mu", "bench_scale_run"])
def test_entry_points_refuse_missing_cuda(monkeypatch, tmp_path, entry):
    cfg = tt.MODEL_ZOO["tiny"]
    tp, ts = tt.init_params(torch.Generator().manual_seed(0), cfg, 3,
                            device="cpu")
    if entry == "cli_wav":       # a model dir and a wav.scp the CLI can read
        C.save_iteration(TR.Trainer(TR.TrainConfig(model="tiny",
                                                   num_targets=3),
                                    str(tmp_path / "exp"), device="cpu"), 0)
        (tmp_path / "wav.scp").write_text("")
    plda = BP.Plda(np.zeros(4), np.eye(4), np.ones(4))
    spk = {f"s{i}": np.eye(4)[:2] + i for i in range(3)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "init_params": lambda: tt.init_params(torch.Generator(), cfg, 3),
        "params_from_numpy": lambda: params_from_numpy(
            *params_to_numpy(tp, ts)),
        "extractor": lambda: TE.XvectorExtractor(cfg, tp, ts),
        "preprocess": lambda: TE.preprocess(np.zeros((40, 23), np.float32)),
        "Trainer": lambda: TR.Trainer(
            TR.TrainConfig(model="tiny", num_targets=3), str(tmp_path)),
        # a tensor that is not on the CPU: the kernels or an error, never
        # the plain versions
        "conv1d_same_fused_bwd": lambda: CB.conv1d_same_fused_bwd(
            torch.zeros(2, 8, 16, dtype=torch.bfloat16, device="meta"),
            torch.zeros(3, 16, 8, dtype=torch.bfloat16, device="meta"), 1),
        "WaveExtractor": lambda: TE.WaveExtractor(cfg, tp, ts),
        "make_wave_to_xvector": lambda: TE.make_wave_to_xvector(cfg),
        "augment_utterance": lambda: AUG.augment_utterance(
            "music", np.ones(100, np.float32), np.random.RandomState(0),
            AUG.AugmentConfig(), musics=[np.ones(50, np.float32)]),
        "cli_wav": lambda: extract_embedding.main([
            f"--model-dir={tmp_path / 'exp'}", "--model=tiny",
            "--num-targets=3", f"--wav-rspecifier=scp:{tmp_path}/wav.scp",
            f"--output-ark={tmp_path / 'xv.ark'}"]),
        "project_device": lambda: PD.project_device(plda, np.ones((2, 4))),
        "score_matrix": lambda: PD.score_matrix(plda, np.ones((2, 4)),
                                                np.ones((3, 4))),
        "score_trials_device": lambda: PD.score_trials_device(
            plda, {"e": np.ones(4)}, {"t": np.ones(4)}, [("e", "t")]),
        "train_plda_device": lambda: PD.train_plda_device(spk),
        "Recipe": lambda: RUN.Recipe(RUN.RecipeConfig(str(tmp_path / "r"))),
        "import_reference_h5": lambda: EX.import_reference_h5(
            str(tmp_path / "model.h5"), cfg, 3),
        "cli_run": lambda: RUN.main([
            f"--work-dir={tmp_path / 'run'}", "--synthetic-speakers=2",
            "--synthetic-utts=2", "--model=tiny"]),
        "cli_get_egs": lambda: get_egs.main([str(tmp_path / "data"),
                                             str(tmp_path / "egs")]),
        "cli_run_sre16": lambda: run_sre16.main([
            f"--work-dir={tmp_path / 'sre16'}",
            f"--sre16-eval-root={tmp_path / 'eval'}", "--model=tiny"]),
        # the bench modules' measuring functions default to the card
        "bench_measure_train_step": lambda: BH.measure_train_step("tiny"),
        "bench_extract_sweep": lambda: BX.measure(2, 64),
        "bench_dense": lambda: BD.compare(1, 1, model="tiny"),
        "bench_adam_mu": lambda: BA.compare(1, 1, model="tiny"),
        "bench_scale_run": lambda: BS.run_variant(
            str(tmp_path / "corpus"), str(tmp_path / "scale"), False, 5e6),
        "cli_h5": lambda: extract_embedding.main([
            f"--reference-h5={tmp_path / 'model.h5'}", "--model=tiny",
            "--num-targets=3", f"--feats-rspecifier=ark:{tmp_path}/f.ark",
            f"--output-ark={tmp_path / 'xv.ark'}"]),
    }
    with pytest.raises(RuntimeError, match="cuda"):
        calls[entry]()


def test_params_round_trip_exact():
    cfg = jt.MODEL_ZOO["tiny"]
    jp, js = jt.init_params(jax.random.PRNGKey(0), cfg, 5)
    jp, js = jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js)
    tp, ts = params_from_numpy(jp, js, device="cpu")
    assert tp["frame"][1]["w"].shape == (5, 32, 32)     # (K, Cin, Cout)
    back_p, back_s = params_to_numpy(tp, ts)
    assert (jax.tree.structure(back_p) == jax.tree.structure(jp)
            and jax.tree.structure(back_s) == jax.tree.structure(js))
    for a, b in zip(jax.tree.leaves((back_p, back_s)),
                    jax.tree.leaves((jp, js))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# modules whose every top-level function and class the port carries over;
# the rest are the kernel modules, utils.profiling (torch.profiler stands
# in for its jax.profiler trace) and the TPU-only machinery ROADMAP says
# not to port (train/spmd_step.py, utils/compile_cache.py)
COMPLETE = ["backend.metrics", "backend.plda", "backend.plda_device",
            "cli.eval_dnn", "cli.extract_embedding", "cli.get_egs",
            "cli.run", "cli.run_sre16", "cli.train_dnn", "data.allocator",
            "data.archives", "data.corpora", "data.reference_tar",
            "extract.extractor", "io.datadir", "io.shorten", "io.wav",
            "models.heads", "ops.augment", "ops.features",
            "parallel.launch", "parallel.mc_harness", "parallel.mesh",
            "parallel.seqshard", "presets", "runtime.native",
            "train.checkpoints", "train.combine",
            "train.preemption", "train.schedules", "train.trainer",
            "utils.export", "utils.kaldi_conf", "utils.scores"]


@pytest.mark.parametrize("module", COMPLETE)
def test_module_has_every_name_of_its_jax_counterpart(module):
    """The port's module holds every top-level function and class of the
    JAX package's module of the same path, and exports its ``__all__``."""
    import importlib
    import inspect
    jm = importlib.import_module(f"xvector_tpu.{module}")
    pm = importlib.import_module(f"xvector_tpu_torch.{module}")
    want = {n for n, f in vars(jm).items()
            if (inspect.isfunction(f) or inspect.isclass(f))
            and f.__module__ == jm.__name__}
    want |= set(getattr(jm, "__all__", ()))   # presets: data names only
    assert want, module
    assert not want - set(vars(pm)), sorted(want - set(vars(pm)))
    assert set(getattr(jm, "__all__", ())) <= set(getattr(pm, "__all__",
                                                          vars(pm)))
