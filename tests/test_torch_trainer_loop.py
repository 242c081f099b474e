"""Port's outer training loop (``Trainer.train``), checkpoints, retries,
preemption and final combination, on the CPU.

``Trainer.train`` is held to the JAX package's ``Trainer.train`` from the
same numpy weights (SGD at lr 1e-2, 2 epochs × 2 archives, dense blocks and full
and ragged single steps): per-iteration train and valid losses and the
final parameters at ``test_block_step_matches_jax``'s bound, max |port −
JAX| ≤ 1e-4 · max |JAX| per tensor.  The lifecycle tests mirror
``tests/test_trainer.py`` and ``tests/test_fault_tolerance.py``; where they
compare two runs of the port, the final tensors must be bit-identical."""

import json
import os
import signal
import threading
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xvector_tpu.models import tdnn as jt
from xvector_tpu.parallel import mesh as meshlib
from xvector_tpu.train import trainer as JT
from xvector_tpu_torch.models import tdnn as tt
from xvector_tpu_torch.models.convert import params_to_numpy, tree_leaves
from xvector_tpu_torch.train import checkpoints as C
from xvector_tpu_torch.train import combine as TC
from xvector_tpu_torch.train import trainer as TR
from xvector_tpu_torch.train.preemption import GracefulPreemption

from port_helpers import model_pair

NUM_SPK = 6
FEAT = 23


def _batches(seed=0, ragged=False):
    """Three learnable 8×48 minibatches (each speaker has its own mean);
    with ``ragged`` the last one has true length 40."""
    rng = np.random.RandomState(seed)
    means = np.random.RandomState(0).randn(NUM_SPK, FEAT) * 2
    out = []
    for i in range(3):
        y = rng.randint(0, NUM_SPK, 8).astype(np.int32)
        x = (rng.randn(8, 48, FEAT) * 0.3
             + means[y][:, None, :]).astype(np.float16)
        t = 40 if ragged and i == 2 else 48
        x[:, t:] = 0.0
        out.append((x, y, t))
    return out


def _noise_batches(seed, ragged=False):
    """Three 32×48 minibatches of unit noise with random labels (with
    ``ragged`` the last one has true length 40).  The parity run trains on
    these: with 8 or 16 rows a unit's pre-activation can cross zero within
    a few SGD steps at lr 1e-2 in one package and not the other (its
    summation order differs in the last bits), after which the two
    trajectories part by 1e-3 to 5e-2; with 32 rows they stay ~1e-6
    apart."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(3):
        x = rng.randn(32, 48, FEAT).astype(np.float16)
        t = 40 if ragged and i == 2 else 48
        x[:, t:] = 0.0
        out.append((x, rng.randint(0, NUM_SPK, 32).astype(np.int32), t))
    return out


def _cfg(**kw):
    base = dict(num_targets=NUM_SPK, model="tiny", compute_dtype="float32",
                num_epochs=2, block_size=2)
    base.update(kw)
    return TR.TrainConfig(**base)


def _mk(tmp_path, tag, **kw):
    return TR.Trainer(_cfg(**kw), str(tmp_path / tag), device="cpu")


def _metrics(tr):
    with open(os.path.join(tr.work_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _tensors(tr):
    return [t.detach().clone() for t in tree_leaves(tr.params)] + \
        [t.clone() for t in tree_leaves(tr.state)]


def _assert_identical(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _close_norm(got, want, tol=1e-4):
    for a, b in zip(got, want):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-3), \
            (np.abs(a - b).max(), np.abs(b).max())


def test_train_matches_jax_trainer(tmp_path):
    cfg = jt.MODEL_ZOO["tiny"]
    jp, js, tp, ts = model_pair(cfg, num_classes=NUM_SPK)
    archives = [_noise_batches(1), _noise_batches(2, ragged=True)]
    valid = _noise_batches(3)[:1]
    kw = dict(num_targets=NUM_SPK, model="tiny", compute_dtype="float32",
              num_epochs=2, block_size=2, optimizer="sgd",
              initial_effective_lrate=1e-2, final_effective_lrate=1e-2)
    jtr = JT.Trainer(JT.TrainConfig(**kw), str(tmp_path / "jax"),
                     mesh=meshlib.make_mesh(data=2, model=1), feat_dim=FEAT)
    jtr.params = jax.tree.map(jnp.asarray, jp)
    jtr.state = jax.tree.map(jnp.asarray, js)
    jtr.opt_state = jtr.optimizer.init(jtr.params)
    jtr._place_all()
    ttr = TR.Trainer(TR.TrainConfig(**kw), str(tmp_path / "port"),
                     device="cpu")
    ttr.set_params(tp, ts)
    for tr in (jtr, ttr):
        assert tr.train(lambda i: iter(archives[i]), num_archives=2,
                        valid_batches=lambda: iter(valid)) == 4
    recs = {}
    for name, tr in (("jax", jtr), ("port", ttr)):
        recs[name] = {(r["kind"], r["iteration"]): r for r in _metrics(tr)
                      if r.get("kind") in ("train", "valid")}
    assert set(recs["port"]) == set(recs["jax"]) and len(recs["jax"]) == 8
    _close_norm([recs["port"][k]["loss"] for k in sorted(recs["jax"])],
                [recs["jax"][k]["loss"] for k in sorted(recs["jax"])])
    for k, r in recs["port"].items():
        if k[0] == "train":        # a dense block and one single step each
            assert (r["dense_blocks"], r["masked_blocks"],
                    r["single_steps"]) == (1, 0, 1)
    got_p, got_s = params_to_numpy(ttr.params, ttr.state)
    _close_norm(jax.tree.leaves(got_p), jax.tree.leaves(jtr.params))
    _close_norm(jax.tree.leaves(got_s), jax.tree.leaves(jtr.state))
    assert os.readlink(os.path.join(ttr.work_dir, "model_final")) == \
        "model_4"


def test_full_train_loop_checkpoints_and_metrics(tmp_path):
    tr = _mk(tmp_path, "exp", preserve_model_interval=2)
    batches = _batches()
    final = tr.train(lambda i: iter(batches), num_archives=2,
                     valid_batches=lambda: iter(batches[:1]))
    assert final == 4
    assert os.path.islink(os.path.join(tr.work_dir, "model_final"))
    assert os.readlink(os.path.join(tr.work_dir, "model_final")) == "model_4"
    # GC: the last two (3, 4) + preserve-interval multiples (0, 2)
    assert {it for it, _ in C.iteration_dirs(tr.work_dir)} == {0, 2, 3, 4}
    for it in (0, 2, 3, 4):
        d = C.iteration_path(tr.work_dir, it)
        assert sorted(os.listdir(d)) == ["ckpt.pt", "done"]
    recs = _metrics(tr)
    assert {"train", "valid"} <= {r["kind"] for r in recs}
    assert all("time" in r for r in recs)
    train = [r for r in recs if r["kind"] == "train"]
    assert [r["iteration"] for r in train] == [0, 1, 2, 3]
    assert {"loss", "accuracy", "lr", "seconds", "dispatch",
            "device_drain"} <= set(train[0])


def test_checkpoint_round_trip(tmp_path):
    tr = _mk(tmp_path, "a", optimizer="adam")
    tr.train_one_iteration(0, iter(_batches()), 1e-3, 0.0, 1.0)
    C.save_iteration(tr, 1)
    other = _mk(tmp_path, "b", optimizer="adam")
    C.restore_into(other, C.iteration_path(tr.work_dir, 1))
    _assert_identical(_tensors(other), _tensors(tr))
    sa, sb = tr.optimizer.state_dict(), other.optimizer.state_dict()
    assert sa["state"].keys() == sb["state"].keys()
    for k in sa["state"]:
        for name, v in sa["state"][k].items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(sb["state"][k][name]))
    # load_pytrees reads params and state and leaves the trainer alone
    before = _tensors(other)
    p, s = C.load_pytrees(other, C.iteration_path(tr.work_dir, 1))
    _assert_identical([*tree_leaves(p), *tree_leaves(s)], _tensors(tr))
    _assert_identical(_tensors(other), before)
    assert C.latest_complete(tr.work_dir) == 1


def test_diagnostics_run_in_background(tmp_path):
    """Iteration N+1 starts training while iteration N's diagnostics still
    run, and every iteration still gets its valid record."""
    tr = _mk(tmp_path, "exp", num_epochs=1)
    batches = _batches()
    iter1_started = threading.Event()

    def archive_fn(i):
        if i == 1:
            iter1_started.set()
        return iter(batches)

    diag_it = iter(range(100))

    def valid_fn():
        if next(diag_it) == 0:
            # blocks until iteration 1 trains: inline diagnostics would
            # deadlock here, and the timeout turns that into a failure
            assert iter1_started.wait(timeout=120), \
                "iteration 1 never started while diag 0 was running"
        yield from batches[:1]

    assert tr.train(archive_fn, num_archives=3, valid_batches=valid_fn) == 3
    assert sorted(r["iteration"] for r in _metrics(tr)
                  if r["kind"] == "valid") == [0, 1, 2]


def test_background_diagnostics_failure_surfaces(tmp_path):
    tr = _mk(tmp_path, "exp", num_epochs=1)
    batches = _batches()

    def bad_valid():
        raise RuntimeError("diagnostics exploded")
        yield  # pragma: no cover

    with pytest.raises(RuntimeError, match="diagnostics exploded"):
        tr.train(lambda i: iter(batches), num_archives=2,
                 valid_batches=bad_valid)


def test_background_diagnostics_failure_is_prompt(tmp_path):
    """Iteration 0's broken diagnostics stop a 6-iteration run at the next
    iteration boundary."""
    tr = _mk(tmp_path, "exp", num_epochs=2)
    batches = _batches()
    started = []

    def archive_fn(i):
        started.append(i)
        return iter(batches)

    calls = {"n": 0}

    def valid_once_bad():
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("first diagnostics pass broke")
        yield from batches[:1]

    with pytest.raises(RuntimeError, match="first diagnostics"):
        tr.train(archive_fn, num_archives=3, valid_batches=valid_once_bad)
    assert len(started) <= 2, started


def test_diag_error_does_not_mask_training_exception(tmp_path):
    tr = _mk(tmp_path, "exp", num_epochs=1)
    batches = _batches()

    def archive_fn(i):
        if i == 1:
            raise ValueError("the data plane fell over")
        return iter(batches)

    def bad_valid():
        raise RuntimeError("diagnostics also broke")
        yield  # pragma: no cover

    with pytest.raises(ValueError, match="data plane fell over"):
        tr.train(archive_fn, num_archives=2, valid_batches=bad_valid)
    recs = _metrics(tr)
    assert any(r["kind"] == "diag_error" and "diagnostics also broke"
               in r["error"] for r in recs)
    # the failed iteration's device post-mortem
    [fx] = [r for r in recs if r["kind"] == "forensics"]
    assert fx["iteration"] == 1 and fx["backend"] == "cpu"


def test_resume_skips_completed_iterations(tmp_path):
    batches = _batches()
    tr = _mk(tmp_path, "exp", num_epochs=1)
    tr.train(lambda i: iter(batches), num_archives=3)
    want = _tensors(tr)
    link = os.path.join(tr.work_dir, "model_final")
    stamp = os.lstat(link).st_mtime_ns

    tr2 = _mk(tmp_path, "exp", num_epochs=1)
    calls = []

    def batches_fn(i):
        calls.append(i)
        return iter(batches)

    assert tr2.train(batches_fn, num_archives=3) == 3
    assert calls == []
    _assert_identical(_tensors(tr2), want)
    assert os.lstat(link).st_mtime_ns == stamp      # model_final untouched


@pytest.mark.parametrize("optimizer,moments", [
    ("adam", "float32"), ("adam", "bfloat16"), ("tf_adam", "float32"),
    ("sgd", "float32")])
def test_crash_and_resume_is_bit_identical(tmp_path, optimizer, moments):
    """A run killed by a loader failure resumes from its last complete
    checkpoint (params, BN state and optimizer state) and ends with the
    same bits as an uninterrupted run."""
    batches = _batches()
    kw = dict(optimizer=optimizer, adam_moments_dtype=moments)
    ref = _mk(tmp_path, "ref", **kw)
    ref.train(lambda i: iter(batches), num_archives=2)

    crash = _mk(tmp_path, "crash", **kw)
    calls = {"n": 0}

    def flaky(i):
        calls["n"] += 1
        if calls["n"] == 3:
            raise OSError("simulated data-plane failure")
        return iter(batches)

    with pytest.raises(OSError):
        crash.train(flaky, num_archives=2)
    assert C.latest_complete(crash.work_dir) == 2
    resumed = _mk(tmp_path, "crash", **kw)
    assert resumed.train(lambda i: iter(batches), num_archives=2) == 4
    _assert_identical(_tensors(resumed), _tensors(ref))


def test_iteration_zero_failure_rolls_back_to_model_zero(tmp_path):
    batches = _batches()
    ref = _mk(tmp_path, "ref")
    ref.train(lambda i: iter(batches), num_archives=2)

    tr = _mk(tmp_path, "it0", max_iteration_retries=1, retry_backoff_s=0.0)
    fail_once = {"armed": True}

    def loader(i):
        def gen():
            for j, b in enumerate(batches):
                # one minibatch updates the params, then the loader fails
                if j == 1 and fail_once.pop("armed", False):
                    raise OSError("mid-iteration-0 failure")
                yield b
        return gen()

    tr.train(loader, num_archives=2)
    _assert_identical(_tensors(tr), _tensors(ref))
    [retry] = [r for r in _metrics(tr) if r["kind"] == "retry"]
    assert retry["iteration"] == 0 and retry["attempt"] == 0
    assert retry["forensics"] == {"backend": "cpu"}


def test_preemption_mid_iteration_resumes_bit_identically(tmp_path):
    batches = _batches()
    ref = _mk(tmp_path, "ref")
    ref.train(lambda i: iter(batches), num_archives=2)

    pre_tr = _mk(tmp_path, "pre")
    calls = {"n": 0}

    def loader(i):
        calls["n"] += 1
        if calls["n"] == 3:              # the real signal, mid-iteration 2
            def gen():
                yield batches[0]
                os.kill(os.getpid(), signal.SIGTERM)
                yield batches[1]         # stop_check fires before this
                yield batches[2]
            return gen()
        return iter(batches)

    with GracefulPreemption() as pre:
        assert pre_tr.train(loader, num_archives=2, preemption=pre) == 2
        assert pre.requested
    kinds = [r for r in _metrics(pre_tr) if r["kind"] == "preempted"]
    assert kinds and kinds[-1]["where"] == "mid_iteration"
    assert not os.path.exists(os.path.join(pre_tr.work_dir, "model_final"))

    resumed = _mk(tmp_path, "pre")
    assert resumed.train(lambda i: iter(batches), num_archives=2) == 4
    _assert_identical(_tensors(resumed), _tensors(ref))


def test_preemption_at_iteration_boundary(tmp_path):
    batches = _batches()
    tr = _mk(tmp_path, "bnd")
    pre = GracefulPreemption()          # not entered: no handlers needed
    seen = {"n": 0}

    def loader(i):
        seen["n"] += 1
        if seen["n"] == 2:
            def gen():
                yield from batches
                pre.trigger()        # after iteration 1's last minibatch
            return gen()
        return iter(batches)

    assert tr.train(loader, num_archives=2, preemption=pre) == 2
    assert seen["n"] == 2
    kinds = [r for r in _metrics(tr) if r["kind"] == "preempted"]
    assert kinds and kinds[-1]["where"] == "iteration_boundary"


def test_preemption_handler_chains_and_restores():
    hits = []
    marker = lambda s, f: hits.append(s)           # noqa: E731
    prev = signal.signal(signal.SIGTERM, marker)
    try:
        with GracefulPreemption() as pre:
            os.kill(os.getpid(), signal.SIGTERM)
            assert pre.requested
            assert hits == [signal.SIGTERM]
        assert signal.getsignal(signal.SIGTERM) is marker
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_retry_rng_differs_between_attempts(tmp_path, monkeypatch):
    monkeypatch.setitem(tt.MODEL_ZOO, "tiny_dropout", replace(
        tt.MODEL_ZOO["tiny"], name="tiny_dropout", use_dropout=True))
    batches = _batches()
    out = []
    for tag, attempt in (("a", 0), ("b", 1), ("c", 0)):
        tr = _mk(tmp_path, tag, model="tiny_dropout")
        tr.train_one_iteration(0, iter(batches), 1e-2, 0.5, 1.0,
                               attempt=attempt)
        out.append(tr.params["output"]["b"].detach().clone())
    assert not torch.allclose(out[0], out[1])
    assert torch.equal(out[0], out[2])


def test_seed_pinning_guards_resume(tmp_path):
    d = str(tmp_path / "exp")
    C.pin_seed(d, 2468)
    C.pin_seed(d, 2468)
    with pytest.raises(ValueError, match="random-seed"):
        C.pin_seed(d, 1234)


def test_model0_saved_even_with_nonzero_start_iter(tmp_path):
    tr = _mk(tmp_path, "s1")
    tr.train(lambda i: iter(_batches()), num_archives=2, start_iter=3)
    assert C.is_complete(C.iteration_path(str(tmp_path / "s1"), 0))


def test_final_combination_end_to_end(tmp_path):
    tr = _mk(tmp_path, "exp", final_combine=True, combine_opt_steps=24)
    batches = _batches()
    diag = _batches(seed=5)[:2]
    assert tr.train(lambda i: iter(batches), num_archives=3,
                    valid_batches=lambda: iter(diag),
                    train_subset_batches=lambda: iter(diag)) == 6
    link = os.path.join(tr.work_dir, "model_final")
    assert os.readlink(link) == "model_combined"
    assert C.is_complete(os.path.join(tr.work_dir, "model_combined"))
    [comb] = [r for r in _metrics(tr) if r["kind"] == "combine"]
    assert comb["iterations"] == TC.combine_iterations(6, 3) == [4, 5, 6]
    assert abs(sum(comb["weights"]) - 1.0) < 1e-5
    assert comb["combined_loss"] <= comb["final_model_loss"]
    comb_eval = tr.evaluate(iter(diag))
    C.restore_into(tr, C.iteration_path(tr.work_dir, 6))
    last_eval = tr.evaluate(iter(diag))
    assert comb_eval["loss"] <= last_eval["loss"] + 1e-3
    # the candidates and model_0 survive GC
    have = {it for it, p in C.iteration_dirs(tr.work_dir) if C.is_complete(p)}
    assert {0, 4, 5, 6} <= have


def test_combine_candidates_survive_gc(tmp_path):
    tr = _mk(tmp_path, "exp", final_combine=True, preserve_model_interval=0,
             combine_opt_steps=4)
    batches = _batches()
    tr.train(lambda i: iter(batches), num_archives=3,
             train_subset_batches=lambda: iter(batches[:1]))
    have = {it for it, p in C.iteration_dirs(tr.work_dir) if C.is_complete(p)}
    assert set(TC.combine_iterations(6, 3)) <= have
    assert 0 not in have                  # interval 0 keeps no multiples


@pytest.mark.parametrize("reason", [
    "no complete candidate checkpoints", "no diagnostics batches provided",
    "diagnostics batches yielded no data", "non-finite combination weights"])
def test_final_combine_skip_reasons(tmp_path, reason):
    """Each way the combination can be skipped is logged under its own
    reason, and model_final falls back to the newest iteration."""
    batches = _batches()
    diag = _batches(seed=5)[:1]
    if reason == "non-finite combination weights":
        diag = [(np.full_like(x, np.nan), y, t) for x, y, t in diag]
    diag_fn = {"no diagnostics batches provided": None,
               "diagnostics batches yielded no data": lambda: iter(())}.get(
        reason, lambda: iter(diag))
    tr = _mk(tmp_path, "exp", final_combine=True, combine_opt_steps=4)
    if reason == "no complete candidate checkpoints":
        tr = _mk(tmp_path, "exp")
        tr.train(lambda i: iter(batches), num_archives=3)
        tr._final_combine([7, 8], diag_fn)
    else:
        tr.train(lambda i: iter(batches), num_archives=3,
                 valid_batches=diag_fn)
    link = os.path.join(tr.work_dir, "model_final")
    assert os.readlink(link) == "model_6"
    recs = _metrics(tr)
    [skip] = [r for r in recs if r["kind"] == "combine_skipped"]
    assert skip["reason"] == reason
    assert not any(r["kind"] == "combine" for r in recs)


@pytest.mark.parametrize("kw", [dict(head="am_softmax"),
                                dict(adam_moments_dtype="bfloat16")],
                         ids=["am_softmax", "bf16_moments"])
def test_variant_trains(tmp_path, kw):
    tr = _mk(tmp_path, "exp", **kw)
    batches = _batches()
    first = tr.train_one_iteration(0, iter(batches), 1e-3, 0.0, 1.0)
    for it in range(1, 4):
        last = tr.train_one_iteration(it, iter(batches), 1e-3, 0.0, 1.0)
    assert last["loss"] < first["loss"]
    if "adam_moments_dtype" in kw:
        p = tree_leaves(tr.params)[0]
        assert tr.optimizer.state[p]["mu"].dtype == torch.bfloat16
        assert tr.optimizer.state[p]["nu"].dtype == torch.float32
