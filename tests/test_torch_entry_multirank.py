"""The port's entry points on several ranks: gloo processes on the CPU
under the launch contract (``XVEC_*`` variables, ``--device=cpu``), at
``tiny`` width, against the JAX package's single controller on a mesh of
as many devices and against one rank; the local-card launcher's decisions
and its handling of the ranks, with ``torch.cuda.device_count`` patched.

Tolerances: ``cli.train_dnn`` on 2 ranks against the JAX CLI (which pads
every minibatch to a multiple of the conftest's 8 CPU devices), f32 SGD
over 2 iterations: ``model_final`` within 1e-5 (``tests/test_scaling.py``'s
bound for a mesh against one device).  One SGD iteration on 3 ranks with
minibatches that 3 does not divide, against the JAX ``Trainer`` on a
3-device mesh: 1e-6 (``tests/test_torch_multiprocess.py``'s one-step
bound).  ``cli.eval_dnn`` on 2 ranks against 1: loss and accuracy 1e-6.
A stop signal to one rank: the resumed run equals the straight run bit
for bit.
"""

import glob
import json
import os
import signal
import sys
import threading
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from port_helpers import model_pair
from test_run_sre16 import corpus  # noqa: F401
from xvector_tpu.cli import train_dnn as jcli
from xvector_tpu.models import tdnn as jt
from xvector_tpu.parallel import mesh as jmesh
from xvector_tpu.train import checkpoints as JC
from xvector_tpu.train import trainer as JT
from xvector_tpu_torch.cli import eval_dnn
from xvector_tpu_torch.cli import run as RUN
from xvector_tpu_torch.data import archives as AR
from xvector_tpu_torch.models.convert import (params_from_numpy,
                                              params_to_numpy, tree_leaves)
from xvector_tpu_torch.parallel import launch
from xvector_tpu_torch.parallel import mesh as meshlib
from xvector_tpu_torch.train import checkpoints as C
from xvector_tpu_torch.train import trainer as TR

NUM_SPK = W.NUM_SPK
TIMEOUT = 100           # seconds per group of ranks: a hung rank fails
FRAMES = 48
LR = ("--initial-effective-lrate=0.01", "--final-effective-lrate=0.01")


@pytest.fixture(scope="module")
def weights():
    jp, js, _, _ = model_pair(jt.MODEL_ZOO["tiny"], seed=0,
                              num_classes=NUM_SPK)
    return jp, js


def _egs(d, rows, n_archives=2, per_archive=2, valid=False, seed=0):
    """Archives of ``per_archive`` minibatches of ``rows`` rows x 48
    frames of unit noise with random labels, and a valid archive."""
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(seed)

    def mb():
        return (rng.randn(rows, FRAMES, W.FEAT).astype(np.float16),
                rng.randint(0, NUM_SPK, rows).astype(np.int32), FRAMES)

    for a in range(n_archives):
        AR.write_archive(os.path.join(d, f"egs.{a}.xta"),
                         [mb() for _ in range(per_archive)])
    if valid:
        AR.write_archive(os.path.join(d, "valid_egs.xta"), [mb(), mb()])
    return str(d)


def _cli(module, world, argv, tmp, tag, **extra):
    """``module``'s main on ``world`` gloo ranks of the launch contract."""
    return W.run("cli", world, {"module": module, "argv": argv, **extra},
                 tmp, timeout=TIMEOUT, tag=tag)


def _train_argv(egs, work, *extra):
    return ["--model=tiny", f"--num-targets={NUM_SPK}", "--num-epochs=1",
            "--compute-dtype=float32", *LR, f"--egs-dir={egs}",
            f"--dir={work}", "--block-size=2", *extra]


def _port_final(work):
    ckpt = torch.load(os.path.join(os.path.realpath(
        os.path.join(work, "model_final")), C.CKPT), weights_only=True)
    return params_to_numpy(ckpt["params"], ckpt["state"])


# ---------------------------------------------------------------------------
# cli.train_dnn on 2 ranks against the JAX CLI; cli.eval_dnn
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained(tmp_path_factory, weights):
    """The port's ``cli.train_dnn`` on 2 ranks and the JAX package's on
    its 8-device mesh, f32 SGD at lr 1e-2, 2 iterations of one block of 2
    minibatches of 33 rows (the port pads each to 34, the JAX package to
    40), both starting from the same numpy weights carried in as
    ``model_0``.

    Two correct runs whose sums round differently stay ~3e-7 apart here.
    They part by 1e-4 to 1e-2 once a unit of this small model sits at the
    edge between dead and alive over a whole minibatch, so that rounding
    decides whether its gradient flows (``tests/test_torch_trainer_loop.py``
    notes the same).  That happens at one in five of the seeds tried for
    the port against JAX, and as often for the port's one rank against
    its two or against the same minibatches padded in one process: it is
    not the padding.  Unit noise, 33 rows and 4 steps keep it rare, and
    the data's seed 0 has none."""
    tmp = tmp_path_factory.mktemp("trained")
    egs = _egs(tmp / "egs", rows=33, valid=True)
    jp, js = weights
    port_work, jax_work = str(tmp / "port"), str(tmp / "jax")

    tr = TR.Trainer(TR.TrainConfig(model="tiny", num_targets=NUM_SPK,
                                   optimizer="sgd", momentum=0.5),
                    port_work, feat_dim=W.FEAT, device="cpu")
    tr._place_all(*params_from_numpy(jp, js, device="cpu"))
    C.save_iteration(tr, 0)
    ranks = _cli("xvector_tpu_torch.cli.train_dnn", 2,
                 _train_argv(egs, port_work, "--device=cpu"), tmp, "train",
                 sgd=True)

    jcfg = partial(JT.TrainConfig, optimizer="sgd", momentum=0.5)
    jtr = JT.Trainer(jcfg(model="tiny", num_targets=NUM_SPK), jax_work,
                     feat_dim=W.FEAT)
    jtr.params = jax.tree.map(jnp.asarray, jp)
    jtr.state = jax.tree.map(jnp.asarray, js)
    jtr.opt_state = jtr.optimizer.init(jtr.params)
    jtr._place_all()
    JC.save_iteration(jtr, 0)
    jcli_cfg = jcli.TrainConfig
    jcli.TrainConfig = jcfg
    try:
        jcli.main(_train_argv(egs, jax_work))
    finally:
        jcli.TrainConfig = jcli_cfg
    JC.restore_into(jtr, os.path.realpath(os.path.join(jax_work,
                                                       "model_final")))
    want = jax.tree.map(np.asarray, (jtr.params, jtr.state))
    return {"egs": egs, "port": port_work, "jax": want, "ranks": ranks}


def test_train_dnn_two_ranks_matches_jax_train_dnn(trained):
    ranks = trained["ranks"]
    assert all(r["imported"] == [] for r in ranks)   # the port alone
    got = _port_final(trained["port"])
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(trained["jax"])):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
    # rank 0 alone reports and writes the global records
    assert "trained 2 iterations" in ranks[0]["stdout"]
    assert ranks[1]["stdout"] == ""
    assert os.path.exists(os.path.join(trained["port"], "accuracy.report"))
    with open(os.path.join(trained["port"], "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert {r.get("process") for r in records} == {0}
    assert {"train", "valid"} <= {r.get("kind") for r in records}


def test_eval_dnn_two_ranks_matches_one(weights, tmp_path, capsys):
    """9-row minibatches (padded to 10 on 2 ranks) through a checkpoint of
    the carried weights."""
    egs = _egs(tmp_path / "egs", rows=9, valid=True)
    tr = TR.Trainer(TR.TrainConfig(model="tiny", num_targets=NUM_SPK),
                    str(tmp_path / "exp"), feat_dim=W.FEAT, device="cpu")
    tr._place_all(*params_from_numpy(*weights, device="cpu"))
    C.save_iteration(tr, 0)
    argv = [f"--model-dir={C.iteration_path(tr.work_dir, 0)}",
            "--model=tiny", f"--num-targets={NUM_SPK}",
            f"--egs={egs}/valid_egs.xta", "--device=cpu"]
    ranks = _cli("xvector_tpu_torch.cli.eval_dnn", 2, argv, tmp_path,
                 "eval")
    one = eval_dnn.main(argv)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["loss"] == one["loss"]
    for r in ranks:
        assert abs(r["result"]["loss"] - one["loss"]) < 1e-6
        assert abs(r["result"]["accuracy"] - one["accuracy"]) < 1e-6
    assert json.loads(ranks[0]["stdout"])["egs"].endswith("valid_egs.xta")
    assert ranks[1]["stdout"] == ""


def test_recipe_on_three_ranks(tmp_path, capsys):
    """``cli.run`` on 3 ranks (8-row minibatches: padded to 9): rank 0
    alone runs the host stages, extracts and scores; every rank trains.
    Its EER is within one target trial's step of one rank's."""
    argv = ["--synthetic-speakers=4", "--synthetic-utts=6", "--model=tiny",
            "--compute-dtype=float32", "--device=cpu"]
    ranks = _cli("xvector_tpu_torch.cli.run", 3,
                 [f"--work-dir={tmp_path / 'three'}", *argv], tmp_path,
                 "run")
    one = RUN.main([f"--work-dir={tmp_path / 'one'}", *argv])
    capsys.readouterr()
    got = ranks[0]["result"]
    assert [r["result"] for r in ranks[1:]] == [None, None]
    assert "== stage 1" in ranks[0]["stdout"]
    for r in ranks[1:]:
        assert "== stage" not in r["stdout"] and "EER" not in r["stdout"]
    assert got["num_trials"] == one["num_trials"]
    targets = 4 * 6 // 2                  # the test half of each speaker
    assert abs(got["eer"] - one["eer"]) <= 1.0 / targets + 1e-9
    with open(tmp_path / "three" / "exp" / "metrics.jsonl") as f:
        kinds = {json.loads(line).get("kind") for line in f}
    assert "train" in kinds


def test_run_sre16_on_two_ranks(corpus, tmp_path):  # noqa: F811
    """``cli.run_sre16`` on 2 ranks (``tests/test_torch_run_sre16.py``'s
    tiny run): rank 0 alone preps, extracts, scores and writes the
    outputs; rank 1 trains and returns nothing."""
    work = tmp_path / "exp"
    argv = ["--work-dir", str(work), "--device", "cpu",
            "--swbd-cell1-root", str(corpus / "LDC2001S13"),
            "--sre-data-dir", str(corpus / "sre_datadir"),
            "--sre16-eval-root", str(corpus / "R149_0_1"),
            "--sre16-key-root",
            str(corpus / "download" / "sre16_evaluation_key"),
            "--sre16-major-root", str(corpus / "major"),
            "--model", "tiny", "--num-epochs", "1", "--min-chunk", "40",
            "--max-chunk", "80", "--min-utt-frames", "39",
            "--min-spk-utts", "2", "--minibatch-size", "8",
            "--compute-dtype", "float32", "--lda-dim", "8",
            "--frames-per-iter", "25000", "--num-repeats", "6"]
    ranks = _cli("xvector_tpu_torch.cli.run_sre16", 2, argv, tmp_path,
                 "sre16")
    res = ranks[0]["result"]
    assert set(res) == {"out_of_domain", "adapted"}
    assert all(res[v]["num_trials"] == 32 for v in res)
    assert ranks[1]["result"] is None and ranks[1]["stdout"] == ""
    assert "== stage 8-10" in ranks[0]["stdout"]
    assert set(json.load(open(work / "sre16_results.json"))) == set(res)
    walls = json.load(open(work / "stage_walls.json"))
    assert set(walls) == {"prep_augment", "features", "egs", "train",
                          "extract", "backend", "total"}
    assert walls["train"] > 0


# ---------------------------------------------------------------------------
# row padding on 3 ranks against the JAX 3-device mesh; Rank0Stage
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pad3(tmp_path_factory, weights):
    tmp = tmp_path_factory.mktemp("pad3")
    return W.run("pad3", 3, {"tiny": weights, "work": str(tmp)}, tmp,
                 timeout=TIMEOUT)


def test_three_ranks_pad_rows_like_the_jax_three_device_mesh(pad3, weights,
                                                            tmp_path):
    """8-row minibatches on 3 ranks: 3 + 3 + 2 real rows and one pad row
    of weight 0, one SGD iteration against the JAX ``Trainer`` on a
    3-device mesh, which pads them to 9 itself."""
    assert all(r["rows"] == [3, 3] for r in pad3)
    for r in pad3[1:]:               # every rank holds the same bits
        for a, b in zip(jax.tree.leaves(r["sgd"][1:]),
                        jax.tree.leaves(pad3[0]["sgd"][1:])):
            np.testing.assert_array_equal(a, b)
    jp, js = weights
    jtr = JT.Trainer(JT.TrainConfig(num_targets=NUM_SPK, model="tiny",
                                    compute_dtype="float32", block_size=2,
                                    optimizer="sgd", momentum=0.5),
                     str(tmp_path),
                     mesh=jmesh.make_mesh(devices=jax.devices()[:3]),
                     feat_dim=W.FEAT)
    jtr.params = jax.tree.map(jnp.asarray, jp)
    jtr.state = jax.tree.map(jnp.asarray, js)
    jtr.opt_state = jtr.optimizer.init(jtr.params)
    jtr._place_all()
    stats = jtr.train_one_iteration(0, iter(W.scaling_batches(n=2, mb=8)),
                                    lr=1e-3, dropout=0.0, shrink=1.0)
    loss, params, state = pad3[0]["sgd"]
    assert abs(stats["loss"] - loss) < 1e-6
    for a, b in zip(jax.tree.leaves((params, state)),
                    jax.tree.leaves((jtr.params, jtr.state))):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=1e-6)


def test_rank0_stage_hands_its_result_and_its_failure_to_every_rank(pad3):
    assert [r["stage"] for r in pad3] == [{"from": 0}] * 3
    assert pad3[0]["failing"] == "ValueError: rank 0's stage failed"
    for r in pad3[1:]:
        assert r["failing"] == ("RuntimeError: rank 0 failed in its "
                                "'failing' stage")


@pytest.mark.parametrize("world", [2, 3, 7])
def test_local_rows_pads_to_the_data_axis(world):
    """Each rank's rows of a padded 64-row minibatch: together the
    minibatch and zero rows, each tagged with the 64 real rows."""
    x = np.arange(64 * 2 * 3, dtype=np.float16).reshape(64, 2, 3)
    y = np.arange(64, dtype=np.int32)
    parts = []
    for rank in range(world):
        mesh = meshlib.Mesh(world, 1, rank, torch.device("cpu"))
        [(xl, yl, t, n)] = list(launch.local_rows([(x, y, 2)], mesh))
        assert (t, n) == (2, 64) and xl.shape[0] == -(-64 // world)
        parts.append((xl, yl))
    xs = np.concatenate([p[0] for p in parts])
    ys = np.concatenate([p[1] for p in parts])
    np.testing.assert_array_equal(xs[:64], x)
    np.testing.assert_array_equal(ys[:64], y)
    assert not xs[64:].any() and not ys[64:].any()
    # one data index: the minibatch passes as it is
    one = meshlib.Mesh(1, 2, 1, torch.device("cpu"))
    assert list(launch.local_rows([(x, y, 2)], one))[0][0] is x


# ---------------------------------------------------------------------------
# a stop signal that reaches one rank
# ---------------------------------------------------------------------------

def test_sigterm_to_one_rank_stops_every_rank_and_resumes_exactly(tmp_path):
    """Rank 1 alone gets SIGTERM as the trainer takes its 11th minibatch
    (iteration 1 of 4, minibatch 3; 7-row minibatches, so padded):
    both ranks stop at the same place, the next block boundary, and the
    rerun ends on the straight run's bits."""
    egs = _egs(tmp_path / "egs", rows=7, per_archive=8)
    module = "xvector_tpu_torch.cli.train_dnn"
    argv = partial(_train_argv, egs)

    def run(work, tag, **extra):
        return _cli(module, 2, [*argv(str(tmp_path / work), "--device=cpu"),
                                "--num-epochs=2"], tmp_path, tag, **extra)

    stopped = run("exp", "stop", sigterm={1: 11})
    assert "preempted after 1 complete iterations" in stopped[0]["stdout"]
    with open(tmp_path / "exp" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    pre = sorted((r["process"], r["iteration"], r["where"])
                 for r in records if r.get("kind") == "preempted")
    assert pre == [(0, 1, "mid_iteration"), (1, 1, "mid_iteration")]
    assert C.latest_complete(str(tmp_path / "exp")) == 1
    resumed = run("exp", "resume")
    assert "trained 4 iterations" in resumed[0]["stdout"]
    run("straight", "straight")
    got, want = (_port_final(str(tmp_path / w)) for w in ("exp", "straight"))
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the launcher: when it starts ranks, their environment, failures, signals
# ---------------------------------------------------------------------------

CHILD = r"""
import json, os, signal, sys, time
mode, out = sys.argv[1], sys.argv[2]
rank = int(os.environ["XVEC_PROCESS_ID"])
keys = ("XVEC_COORDINATOR", "XVEC_NUM_PROCESSES", "XVEC_PROCESS_ID",
        "PYTHONPATH")
stopped = []
signal.signal(signal.SIGTERM, lambda *a: stopped.append(1))
with open(os.path.join(out, f"env_{rank}.json"), "w") as f:
    json.dump({k: os.environ.get(k) for k in keys}, f)
if mode == "ok":
    with open(os.path.join(out, f"argv_{rank}.json"), "w") as f:
        json.dump(sys.argv[1:], f)
elif mode == "fail":
    if rank == 1:
        sys.exit(7)
    time.sleep(60)
elif mode == "signal":
    deadline = time.monotonic() + 60
    while not stopped and time.monotonic() < deadline:
        time.sleep(0.05)
    sys.exit(0 if stopped else 3)
"""


@pytest.fixture
def cards(monkeypatch, tmp_path):
    """Three visible cards, no launch variables, and the parent's kernel
    build recorded instead of run."""
    for key in ("XVEC_NUM_PROCESSES", "XVEC_PROCESS_ID", "XVEC_COORDINATOR"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    builds = []
    monkeypatch.setattr(launch, "_build_once", lambda: builds.append(1))
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    return str(script), builds


@pytest.mark.parametrize("device, count, env, want", [
    ("cuda", 3, {}, True), ("cuda", 2, {}, True),
    ("cuda:1", 2, {}, False), ("cuda:0", 3, {}, False),
    ("cpu", 3, {}, False), ("cuda", 1, {}, False),
    ("cuda", 3, {"XVEC_NUM_PROCESSES": "1"}, False)])
def test_spawn_decision(monkeypatch, device, count, env, want):
    monkeypatch.delenv("XVEC_NUM_PROCESSES", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    assert launch.spawns(device) is want


def test_entry_point_reruns_itself_on_every_card(cards, monkeypatch,
                                                 tmp_path):
    """Through ``launch.run``: ``python -m <module> <argv>`` for a call
    with argv, the process's own command line for a program's call; the
    body does not run in the launching process, which returns what
    ``read_result`` reads once the ranks have ended (None without it)."""
    seen = []
    monkeypatch.setattr(launch, "spawn_local_ranks",
                        lambda command, work: seen.append(command))
    body = lambda *a: pytest.fail("the launcher ran the body itself")
    assert launch.run("pkg.cli", ["--x=1"], "cuda", str(tmp_path), body,
                      read_result=lambda: seen and "r0") == "r0"
    assert launch.run("pkg.cli", None, "cuda", str(tmp_path), body) is None
    assert seen == [["-m", "pkg.cli", "--x=1"], sys.orig_argv[1:]]


def test_launcher_starts_one_rank_per_card(cards, tmp_path):
    script, builds = cards
    out = tmp_path / "out"
    out.mkdir()
    assert launch.spawn_local_ranks([script, "ok", str(out)],
                                    str(tmp_path)) is None
    assert builds == [1]                     # built once, in the parent
    envs = [json.loads((out / f"env_{r}.json").read_text())
            for r in range(3)]
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(launch.__file__))))
    coordinator = envs[0]["XVEC_COORDINATOR"]
    assert coordinator.startswith("file://" + str(tmp_path / ".ranks"))
    for r, env in enumerate(envs):
        assert env["XVEC_COORDINATOR"] == coordinator
        assert (env["XVEC_NUM_PROCESSES"], env["XVEC_PROCESS_ID"]) == (
            "3", str(r))
        assert json.loads((out / f"argv_{r}.json").read_text()) == [
            "ok", str(out)]
        assert env["PYTHONPATH"].split(os.pathsep)[0] == root
    assert not glob.glob(str(tmp_path / ".ranks" / "*"))   # store removed


def test_launcher_stops_every_rank_when_one_fails(cards, tmp_path, capsys):
    script, _ = cards
    out = tmp_path / "out"
    out.mkdir()
    t0 = time.monotonic()
    with pytest.raises(SystemExit) as e:
        launch.spawn_local_ranks([script, "fail", str(out)], str(tmp_path))
    assert e.value.code == 7
    assert time.monotonic() - t0 < 30        # ranks 0 and 2 were killed
    assert "rank 1 of 3 failed with exit code 7" in capsys.readouterr().err


def test_launcher_stops_every_rank_past_its_timeout(cards, tmp_path,
                                                    capsys):
    script, _ = cards
    out = tmp_path / "out"
    out.mkdir()
    t0 = time.monotonic()
    with pytest.raises(SystemExit) as e:
        launch.spawn_local_ranks([script, "signal", str(out)],
                                 str(tmp_path), timeout=2)
    assert e.value.code == 124 and time.monotonic() - t0 < 30
    assert "ran past 2 s" in capsys.readouterr().err


def test_launcher_forwards_sigterm_to_every_rank(cards, tmp_path):
    """A SIGTERM to the launcher reaches each rank (which stops cleanly,
    as ``GracefulPreemption`` lets it), and the launcher's own handler
    comes back afterwards."""
    script, _ = cards
    out = tmp_path / "out"
    out.mkdir()
    before = signal.getsignal(signal.SIGTERM)

    def send():
        deadline = time.monotonic() + 30
        while (len(glob.glob(str(out / "env_*.json"))) < 3
               and time.monotonic() < deadline):
            time.sleep(0.05)
        time.sleep(0.3)                 # each child's handler is set
        os.kill(os.getpid(), signal.SIGTERM)

    # the launcher forwards from the main thread's handlers
    assert threading.current_thread() is threading.main_thread()
    sender = threading.Thread(target=send)
    sender.start()
    try:
        launch.spawn_local_ranks([script, "signal", str(out)],
                                 str(tmp_path))
    finally:
        sender.join(timeout=40)
    assert not sender.is_alive()
    assert signal.getsignal(signal.SIGTERM) is before
