"""Multi-process end-to-end harness: the reference's whole training
contract under several ranks over one shared work dir.

Counterpart of ``xvector_tpu/parallel/mc_harness.py``.  It drives the
reference's L4 training contract (``train_dnn.py:463-593``) under N real
processes joined by ``torch.distributed`` (gloo on the CPU, or gloo or
NCCL on cards) over ONE shared work dir, the coordination surface where
multi-process bugs live:

* per-rank materialisation of real ``.xta`` archives
  (:func:`~.launch.shard_archives`, the ``get_egs.sh:195-204`` nj
  fan-out); a rank with no archive still passes every barrier;
* ``Trainer.train``'s full outer loop (schedules, iteration checkpoints
  written by rank 0 behind barriers, ``done`` sentinels and GC, inline
  held-out diagnostics, final combination);
* a deterministic stop after ``STOP_AFTER`` iterations (every rank reads
  the shared checkpoint state, so all stop at the same safe point: a
  signal's timing could desync the ranks' collectives), process exit, and
  FRESH processes resuming from the shared checkpoints to the end;
* utterance-sharded extraction with the final model.

The workers are ``subprocess``es running a written script that imports
only this package; ``device`` and ``backend`` are explicit, and each
worker runs with ``OMP_NUM_THREADS=1`` so that groups of ranks do not
oversubscribe the host.  On a timeout every worker is killed and every
worker's output reported.  :func:`run_single_controller` is the
one-process parity target on the same corpus and plans.

A ``spec`` dict, written as JSON for the workers, carries what a run may
change: ``train`` (``TrainConfig`` fields), ``extract``
(``ExtractorConfig`` fields), ``global_mb``, ``frames`` (the corpus's
utterance length), ``valid`` (an archive for the diagnostics instead of
archive 0's first minibatch), ``params_flat`` (every parameter in the
result: small models only) and ``timing`` (time the gradient all-reduce
and a checkpoint save).  The ranks of a group meet through a store file
in the work dir.  Archives already in the work dir are used as they are.
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

NUM_SPK = 8
FEAT = 23
UTTS_PER_SPK = 6          # speaker 0 gets 2 extra utts: the 50-utt total
#                           makes extraction shards UNEVEN at any rank
#                           count that does not divide 50
FRAMES = 120
NUM_ARCHIVES = 2
GLOBAL_MB = 8
NUM_EPOCHS = 2            # x num_archives archives = iteration count
STOP_AFTER = 2            # the "kill" point of the interrupted run
TIMEOUT_S = 110           # per group of workers


def build_corpus(work: str, seed: int = 0, frames: int = FRAMES):
    """Write the shared feature ark + utt2spk: linearly separable speaker
    means so four iterations of Adam visibly learn."""
    from ..io import kaldi_ark as kio
    os.makedirs(work, exist_ok=True)
    ark = os.path.join(work, "egs_feats.ark")
    if os.path.exists(ark + ".done"):
        return
    rng = np.random.RandomState(seed)
    means = rng.randn(NUM_SPK, FEAT) * 2.0
    with kio.ArkWriter(ark, ark + ".scp") as w, \
            open(os.path.join(work, "utt2spk"), "w") as f:
        for s in range(NUM_SPK):
            for u in range(UTTS_PER_SPK + (2 if s == 0 else 0)):
                utt = f"s{s}-u{u}"
                mat = (rng.randn(frames, FEAT) * 0.3
                       + means[s]).astype(np.float32)
                w.write(utt, mat)
                f.write(f"{utt} {s}\n")
    open(ark + ".done", "w").close()


def _utt2src(work: str) -> Dict[str, Tuple[str, int]]:
    out: Dict[str, Tuple[str, int]] = {}
    with open(os.path.join(work, "egs_feats.ark.scp")) as f:
        for line in f:
            utt, loc = line.split()
            path, off = loc.rsplit(":", 1)
            out[utt] = (path, int(off))
    return out


def _plans(work: str, num_archives: int = NUM_ARCHIVES,
           global_mb: int = GLOBAL_MB, frames: int = FRAMES):
    """Archive plans, rebuilt deterministically on every rank from the
    shared manifest (file order fixes dict order fixes the RNG draws)."""
    from ..data import allocator as alloclib
    with open(os.path.join(work, "utt2spk")) as f:
        utt2int = {u: int(s) for u, s in (line.split() for line in f)}
    utt2src = _utt2src(work)
    cfg = alloclib.AllocatorConfig(
        min_frames=40, max_frames=60, minibatch_size=global_mb,
        num_repeats=2, frames_per_iter=20000, length_bucket=8, seed=77)
    plans = list(alloclib.allocate_archives(
        {u: frames for u in utt2src}, utt2int, cfg,
        num_archives=num_archives))
    return plans, utt2src


def _train_cfg(final_combine: bool = False, **overrides):
    from ..train.trainer import TrainConfig
    fields = dict(num_targets=NUM_SPK, model="tiny",
                  compute_dtype="float32", block_size=2,
                  num_epochs=NUM_EPOCHS, final_combine=final_combine,
                  combine_opt_steps=12 if final_combine else 80)
    fields.update(overrides)
    return TrainConfig(**fields)


def _model_cfg(name: str = "tiny"):
    from dataclasses import replace

    from ..models import tdnn
    return replace(tdnn.MODEL_ZOO[name], feat_dim=FEAT)


def _extract_utts(work: str, params, state, utts: Sequence[str], utt2src,
                  device="cpu", model: str = "tiny",
                  **extract) -> Dict[str, list]:
    from ..extract.extractor import ExtractorConfig, XvectorExtractor
    from ..io import kaldi_ark as kio
    cfg = dict(min_chunk=20, max_chunk=200, batch_size=4,
               compute_dtype="float32")
    cfg.update(extract)
    ex = XvectorExtractor(_model_cfg(model), params, state,
                          ExtractorConfig(**cfg), device=device)
    stream = ((u, kio.read_mat("%s:%d" % utt2src[u])) for u in utts)
    return {u: np.asarray(xv).tolist() for u, xv in ex.extract_iter(stream)}


def tree_sha(tree) -> str:
    """SHA-256 of a tree's tensors' bytes, in ``tree_leaves`` order: equal
    digests mean equal bits."""
    import torch

    from ..models.convert import tree_leaves
    h = hashlib.sha256()
    for t in tree_leaves(tree):
        h.update(t.detach().cpu().contiguous().view(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _launches() -> Dict[str, dict]:
    """The kernel wrappers' launch counts in this process."""
    from ..ops import conv_bwd, tdnn_kernel
    return {"conv": dict(conv_bwd.route_launches),
            "k1": dict(tdnn_kernel.route_launches)}


def worker_main(argv: List[str]):
    """Body of one rank.  argv: rank work phase spec.json.  Phase 1
    materialises this rank's archive shard then trains with the
    deterministic stop at STOP_AFTER iterations; phase 2 resumes from the
    shared checkpoints to completion and extracts this rank's utterance
    shard."""
    import torch

    from ..data import archives as archlib
    from ..io import kaldi_ark as kio
    from ..train import checkpoints as C
    from ..train.trainer import Trainer
    from . import launch
    from . import mesh as meshlib

    t_spawn = float(os.environ.get("XVEC_SPAWN_TIME", time.time()))
    rank, work, phase = int(argv[0]), argv[1], int(argv[2])
    with open(argv[3]) as f:
        spec = json.load(f)
    n = spec["n_procs"]
    device = meshlib.init_distributed(spec["backend"], spec["init_method"],
                                      n, rank, spec["device"])
    mesh = meshlib.make_mesh(data=n, model=1, device=device)
    out = {"start_s": time.time() - t_spawn}
    frames = spec.get("frames", FRAMES)
    global_mb = spec.get("global_mb", GLOBAL_MB)
    num_archives = spec["num_archives"]

    # per-rank materialisation over the shared dir (idempotent: phase 2
    # after an interruption finds them on disk; with more ranks than
    # archives some ranks write NOTHING and still pass the barrier)
    plans = None
    for i in launch.shard_archives(num_archives):
        path = os.path.join(work, f"egs.{i}.xta")
        if not os.path.exists(path):
            if plans is None:
                plans, utt2src = _plans(work, num_archives, global_mb,
                                        frames)
            archlib.materialize_archive(
                plans[i], path,
                lambda u: kio.read_mat("%s:%d" % utt2src[u]))
    meshlib.barrier(mesh.world_group)

    train = dict(spec.get("train", {}))
    tr = Trainer(_train_cfg(spec["final_combine"], **train),
                 os.path.join(work, "exp"), feat_dim=FEAT, mesh=mesh)
    lo, hi = launch.host_local_batch_slice(global_mb, mesh)

    def rows(path):
        with archlib.ArchiveReader(path) as reader:
            for x, y, t in reader:
                yield x[lo:hi], y[lo:hi], t

    def batches(i):
        return rows(os.path.join(work, f"egs.{i}.xta"))

    def valid():
        # the diagnostics minibatches, rank-sliced like the training rows
        # — or NOTHING under empty_diag (the combination's fallback: rank
        # 0 must signal the skip through the broadcast, not leave its
        # peers waiting in it)
        if spec["empty_diag"]:
            return
        if spec.get("valid"):
            yield from rows(spec["valid"])
            return
        for item in batches(0):
            yield item
            return

    stop = None
    if phase == 1:
        # the deterministic "kill": every rank reads the shared checkpoint
        # state, so all stop at the same boundary
        def stop():
            latest = C.latest_complete(tr.work_dir)
            return latest is not None and latest >= STOP_AFTER

    t0 = time.time()
    out["final_iterations"] = tr.train(batches, num_archives=num_archives,
                                       valid_batches=valid, preemption=stop)
    out["train_s"] = time.time() - t0
    if phase == 2:
        w = tr.params["embed"][0]["w"].detach().cpu().numpy()
        out["checksum"] = float(np.sum(np.abs(w)))
        out["w00"] = float(w[0, 0])
        out["params_sha"] = tree_sha(tr.params)
        out["state_sha"] = tree_sha(tr.state)
        out["final_target"] = os.path.basename(os.path.realpath(
            os.path.join(tr.work_dir, "model_final")))
        if spec.get("params_flat", True):
            from ..models.convert import params_to_numpy
            p, _ = params_to_numpy(tr.params, tr.state)
            out["params_flat"] = _flat(p)
        # utterance-sharded extraction (extract_xvectors.sh's nj fan-out)
        utt2src = _utt2src(work)
        utts = sorted(utt2src)[rank::n]
        out["num_utts_local"] = len(utts)
        out["xv"] = _extract_utts(work, tr.params, tr.state, utts, utt2src,
                                  device=device, model=tr.cfg.model,
                                  **spec.get("extract", {}))
        if spec.get("timing"):
            out["timing"] = _time_collectives(tr, mesh)
    out["launches"] = _launches()
    with open(os.path.join(work, f"mc_result_p{phase}_{rank}.json"),
              "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def _flat(tree, prefix="") -> Dict[str, list]:
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}[{k!r}]").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}[{i}]").items()}
    return {prefix: np.asarray(tree).tolist()}


def _time_collectives(tr, mesh, calls: int = 5) -> Dict[str, float]:
    """Milliseconds of the step's flat gradient all-reduce (the size of
    every parameter) and of a checkpoint save with its barriers."""
    import torch

    from ..models.convert import tree_leaves
    from ..train import checkpoints as C
    from . import mesh as meshlib

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    grads = [torch.ones_like(p.detach()) for p in tree_leaves(tr.params)]
    meshlib.all_reduce_flat(grads, mesh.data_group)        # warm up
    sync()
    t0 = time.perf_counter()
    for _ in range(calls):
        meshlib.all_reduce_flat(grads, mesh.data_group)
    sync()
    ar_ms = (time.perf_counter() - t0) / calls * 1e3
    t0 = time.perf_counter()
    C.save_named(tr, "model_timing")
    save_ms = (time.perf_counter() - t0) * 1e3
    return {"grad_allreduce_ms": ar_ms,
            "grad_floats": sum(g.numel() for g in grads),
            "save_ms": save_ms}


def _free_port() -> int:
    """A localhost port that was free when asked, for a ``tcp://``
    rendezvous (the JAX package's harness meets so).  Another process may
    take it before the group binds it, so the harness itself meets through
    a store file in the work dir."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


_WORKER_TEMPLATE = """
import sys
sys.path.insert(0, {repo!r})
from xvector_tpu_torch.parallel import mc_harness
mc_harness.worker_main(sys.argv[1:])
"""


def watch(procs: Sequence[subprocess.Popen],
          timeout: Optional[float] = None) -> Tuple[Optional[int], bool]:
    """Wait for every process.  At the first one that exits with a
    non-zero code, or once ``timeout`` seconds have passed (``None``: no
    limit), every process still running is killed.  Returns (the index of
    that first failed process or None, whether the timeout struck)."""
    deadline = None if timeout is None else time.monotonic() + timeout
    failed, timed_out = None, False
    try:
        pending = list(range(len(procs)))
        while pending and failed is None:
            for i in list(pending):
                if procs[i].poll() is not None:
                    pending.remove(i)
                    if procs[i].returncode != 0:
                        failed = i
                        break
            if deadline is not None and time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return failed, timed_out


def spawn(script: str, argvs: Sequence[Sequence[str]],
          timeout: float = TIMEOUT_S, env: Optional[dict] = None
          ) -> List[str]:
    """Run ``python script <argv>`` once per rank, all at once, and return
    their outputs.  If any worker fails, or the group outlives
    ``timeout`` seconds (a rank died mid-collective and its peers wait),
    every worker still running is killed and every worker's output is
    reported in the ``RuntimeError``."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    full = dict(os.environ if env is None else env)
    full["OMP_NUM_THREADS"] = "1"
    full["PYTHONPATH"] = repo + os.pathsep + full.get("PYTHONPATH", "")
    full["XVEC_SPAWN_TIME"] = repr(time.time())
    logs = [tempfile.TemporaryFile() for _ in argvs]
    procs = [subprocess.Popen([sys.executable, script, *map(str, argv)],
                              env=full, stdout=log, stderr=subprocess.STDOUT)
             for argv, log in zip(argvs, logs)]
    failed, timed_out = watch(procs, timeout)
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read().decode(errors="replace"))
        log.close()
    if timed_out or failed is not None:
        why = (f"timed out after {timeout}s" if timed_out
               else f"worker {failed} failed")
        raise RuntimeError(
            f"{os.path.basename(script)}: {why}; worker outputs:\n"
            + "\n--- next worker ---\n".join(
                f"[rank {i}, exit {p.returncode}]\n{o[-4000:]}"
                for i, (p, o) in enumerate(zip(procs, outs))))
    return outs


def _spawn_group(work: str, phase: int, spec: dict,
                 timeout: float = TIMEOUT_S) -> List[dict]:
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    worker = os.path.join(work, "mc_worker.py")
    if not os.path.exists(worker):
        with open(worker, "w") as f:
            f.write(_WORKER_TEMPLATE.format(repo=repo))
    n = spec["n_procs"]
    # a rendezvous no earlier group used
    init = "file://" + os.path.join(work, f"rdv_p{phase}_{time.time_ns()}")
    spec = dict(spec, init_method=init)
    spec_path = os.path.join(work, f"mc_spec_p{phase}.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    spawn(worker, [[r, work, phase, spec_path] for r in range(n)], timeout)
    out = []
    for r in range(n):
        with open(os.path.join(work, f"mc_result_p{phase}_{r}.json")) as f:
            out.append(json.load(f))
    return out


def run_group(work: str, interrupt: bool = True, n_procs: int = 2,
              num_archives: int = NUM_ARCHIVES,
              final_combine: bool = False, empty_diag: bool = False,
              device: str = "cpu", backend: str = "gloo",
              timeout: float = TIMEOUT_S,
              spec: Optional[dict] = None) -> Dict:
    """The full N-rank flow.  ``interrupt=True`` runs phase 1 (train,
    deterministic stop after STOP_AFTER iterations, exit) then phase 2
    with FRESH processes (resume from the shared checkpoints, finish,
    extract); ``interrupt=False`` runs phase 2 alone, one uninterrupted
    group.  Every rank must end with the same bits."""
    spec = dict(spec or {}, n_procs=n_procs, num_archives=num_archives,
                final_combine=final_combine, empty_diag=empty_diag,
                device=device, backend=backend)
    build_corpus(work, frames=spec.get("frames", FRAMES))
    res1 = None
    if interrupt:
        res1 = _spawn_group(work, 1, spec, timeout)
        if any(r["final_iterations"] != STOP_AFTER for r in res1):
            raise RuntimeError(f"phase 1 did not stop after {STOP_AFTER} "
                               f"iterations: {res1}")
    res2 = _spawn_group(work, 2, spec, timeout)
    if any(r["params_sha"] != res2[0]["params_sha"]
           or r["state_sha"] != res2[0]["state_sha"] for r in res2):
        raise RuntimeError("the ranks ended with different bits")
    xv: Dict[str, list] = {}
    for r in res2:
        xv.update(r["xv"])              # merge utterance shards
    return {"final_iterations": res2[0]["final_iterations"],
            "checksum": res2[0]["checksum"], "w00": res2[0]["w00"],
            "params_sha": res2[0]["params_sha"],
            "state_sha": res2[0]["state_sha"],
            "xv": {u: np.asarray(v, np.float32) for u, v in xv.items()},
            "xv_shards": [sorted(r["xv"]) for r in res2],
            "shard_sizes": [r["num_utts_local"] for r in res2],
            "final_target": res2[0].get("final_target"),
            "params_flat": {k: np.asarray(v, np.float32) for k, v in
                            res2[0].get("params_flat", {}).items()},
            "ranks": {"phase1": res1, "phase2": [
                {k: v for k, v in r.items()
                 if k not in ("xv", "params_flat")} for r in res2]},
            "interrupted": interrupt}


def run_two_process(work: str, interrupt: bool = True) -> Dict:
    """The two-rank run of :func:`run_group`."""
    return run_group(work, interrupt=interrupt, n_procs=2)


def run_single_controller(work: str, device="cpu",
                          spec: Optional[dict] = None) -> Dict:
    """The parity target: the identical corpus, plans and loop in ONE
    process, on whole global minibatches."""
    from ..data import archives as archlib
    from ..io import kaldi_ark as kio
    from ..models.convert import params_to_numpy
    from ..train.trainer import Trainer

    spec = dict(spec or {})
    frames = spec.get("frames", FRAMES)
    num_archives = spec.get("num_archives", NUM_ARCHIVES)
    build_corpus(work, frames=frames)
    utt2src = _utt2src(work)
    plans = None
    for i in range(num_archives):
        path = os.path.join(work, f"egs.{i}.xta")
        if not os.path.exists(path):
            if plans is None:
                plans, _ = _plans(work, num_archives,
                                  spec.get("global_mb", GLOBAL_MB), frames)
            archlib.materialize_archive(
                plans[i], path,
                lambda u: kio.read_mat("%s:%d" % utt2src[u]))
    tr = Trainer(_train_cfg(spec.get("final_combine", False),
                            **spec.get("train", {})),
                 os.path.join(work, "exp"), feat_dim=FEAT, device=device)

    def batches(i):
        with archlib.ArchiveReader(os.path.join(work,
                                                f"egs.{i}.xta")) as reader:
            yield from reader

    def valid():
        if spec.get("valid"):
            with archlib.ArchiveReader(spec["valid"]) as reader:
                yield from reader
            return
        for item in batches(0):
            yield item
            return

    t0 = time.time()
    final = tr.train(batches, num_archives=num_archives,
                     valid_batches=valid)
    train_s = time.time() - t0
    w = tr.params["embed"][0]["w"].detach().cpu().numpy()
    xv = _extract_utts(work, tr.params, tr.state, sorted(utt2src), utt2src,
                       device=device, model=tr.cfg.model,
                       **spec.get("extract", {}))
    flat = {}
    if spec.get("params_flat", True):
        p, _ = params_to_numpy(tr.params, tr.state)
        flat = {k: np.asarray(v, np.float32) for k, v in _flat(p).items()}
    return {"final_iterations": final,
            "checksum": float(np.sum(np.abs(w))),
            "w00": float(w[0, 0]), "train_s": train_s,
            "params_sha": tree_sha(tr.params), "params_flat": flat,
            "xv": {u: np.asarray(v, np.float32) for u, v in xv.items()}}
