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
from xvector_tpu_torch.extract import extractor as TE
from xvector_tpu_torch.models import tdnn as tt
from xvector_tpu_torch.models.convert import (params_from_numpy,
                                              params_to_numpy)

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
                                   "extractor", "preprocess"])
def test_entry_points_refuse_missing_cuda(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tt.MODEL_ZOO["tiny"]
    tp, ts = tt.init_params(torch.Generator().manual_seed(0), cfg, 3,
                            device="cpu")
    calls = {
        "init_params": lambda: tt.init_params(torch.Generator(), cfg, 3),
        "params_from_numpy": lambda: params_from_numpy(
            *params_to_numpy(tp, ts)),
        "extractor": lambda: TE.XvectorExtractor(cfg, tp, ts),
        "preprocess": lambda: TE.preprocess(np.zeros((40, 23), np.float32)),
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
