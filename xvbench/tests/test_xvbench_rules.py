"""The benchmark's rules: the contract of ``BENCHMARK.json``, no JAX in a
run, no result without a card or without the program, and files found by
name."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from xvbench import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _run(args, cwd=ROOT, env=None, timeout=600):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_benchmark_json_keeps_the_contract():
    b = harness.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["xvbench"] and b["command"][1].startswith("xvbench/")
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names)) and all(map(NAME.match, names))
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = harness.load_json(ROOT, c["file"])
        assert c["file"] == f"xvbench/configs/{c['name']}.json"
        assert cfg["reduced"] == c["reduced"] == []
    four = [w for w in b["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(b["workloads"]) // 4)
    e2e = {m["name"] for m in b["end_to_end"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200
        traffic = harness.load_json(harness.HERE, "traffic",
                                    w["traffic"] + ".json")
        assert os.path.exists(os.path.join(harness.HERE, "drivers",
                                           traffic["driver"] + ".py"))
        limits = harness.load_json(harness.HERE, "limits",
                                   w["name"] + ".json")
        assert limits and all(v >= 0 for v in limits.values())
        reported = [m["name"] for m in
                    harness.cell_metrics(b, w["name"], "end_to_end")]
        assert "setup_s" in reported and len(reported) >= 2
        assert harness.cell_metrics(b, w["name"], "per_layer")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    for m in b["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert os.path.exists(os.path.join(harness.HERE, "metrics",
                                           m["name"] + ".py"))
    assert len(json.dumps(b)) < 64 * 1024


def test_a_run_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from xvbench import harness\n"
        "from xvbench.tests import tiny\n"
        "from xvbench.drivers import train_egs, extract_feats\n"
        "train_egs.run(tiny.context(tiny.TRAIN, {}, seconds=0.5))\n"
        "extract_feats.run(tiny.context(tiny.EXTRACT, {}, seconds=0.5))\n"
        "print('FORBIDDEN', harness.forbidden_modules())\n" % ROOT)
    out = _run(["-c", code])
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "xvector_tpu_torch_like", sys)
    assert "xvector_tpu_torch_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in harness.forbidden_modules()


def test_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(["xvbench/run.py", "--workload", "no_dropout.train_egs",
                "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
               env=env)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_run_without_the_program_prints_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "xvbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = _run(["xvbench/run.py", "--workload", "no_dropout.extract_feats",
                "--seed", "1", "--seconds", "1"], cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_new_traffic_metric_and_cell_are_found_by_name(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "xvbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = {p: open(os.path.join(dp, p), "rb").read()
              for dp, _, fs in os.walk(tmp_path / "xvbench") for p in fs}
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "no_dropout.new_mix",
                               "config": "no_dropout", "traffic": "new_mix",
                               "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "new.share", "unit": "%",
                               "better": "lower", "source": "host_clock",
                               "layer": "device", "moves": "setup_s",
                               "workloads": ["no_dropout.new_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((tmp_path / "xvbench/traffic/train_egs.json")
                         .read_text())
    traffic["rows"] = 32
    (tmp_path / "xvbench/traffic/new_mix.json").write_text(
        json.dumps(traffic))
    (tmp_path / "xvbench/limits/no_dropout.new_mix.json").write_text(
        json.dumps({"loss_gap": 0.1}))
    (tmp_path / "xvbench/metrics/new.share.py").write_text(
        "def read(c):\n    return 100.0 * c['host']['x']\n")
    code = (
        "import sys, types; sys.path.insert(0, %r)\n"
        "from xvbench import harness\n"
        "a = types.SimpleNamespace(workload='no_dropout.new_mix', seed=1,"
        " seconds=1, trace=1)\n"
        "ctx = harness.make_context(a)\n"
        "assert harness.HERE.startswith(%r)\n"
        "print(ctx.traffic['rows'], [m['name'] for m in ctx.per_layer],"
        " harness.load_reader('new.share')({'host': {'x': 0.25}}))\n"
        "harness.cleanup(ctx)\n" % (str(tmp_path), str(tmp_path)))
    out = _run(["-c", code], cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["32", "['new.share']", "25.0"]
    for p, data in before.items():       # no file that was there changed
        match = [os.path.join(dp, p) for dp, _, fs in
                 os.walk(tmp_path / "xvbench") if p in fs]
        assert any(open(m, "rb").read() == data for m in match)


@pytest.mark.cuda
def test_each_single_card_cell_runs_correct_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for w in harness.benchmark()["workloads"]:
        if w["chips"] != 1:
            continue
        out = _run(["xvbench/run.py", "--workload", w["name"], "--seed",
                    "2147483700", "--seconds", "3", "--trace", "0"],
                   timeout=1200)
        assert out.returncode == 0, out.stderr[-3000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"] and line["failed"] == 0, line["checks"]
