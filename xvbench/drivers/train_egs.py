"""Training as ``cli/train_dnn`` runs it: XTA archives read through
``ArchiveReader``/``PrefetchLoader`` into ``Trainer.train_one_iteration``
(bucketing, stacking into pinned memory on a worker thread, the dense block
step, K2-K4, Adam), on one card or, with ``ranks`` > 1, on that many NCCL
ranks started by ``parallel/launch.run``, each feeding its rows of every
global minibatch (``launch.local_rows``).

Set-up writes the archives, builds the trainer, installs the benchmark's
weights and runs the first ``check_blocks`` calls, one block of one archive
each, which the output check follows; then one block of every other archive
length.  The window is one ``train_one_iteration`` whose minibatches cycle
the archives until the deadline (asked at each archive's start, agreed over
the ranks).  A traced run ends with a second call, under the profiler, for
the traffic's ``trace_seconds``.
"""

from __future__ import annotations

import gc
import itertools
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

from .. import generate, harness, trace as tr, work
from ..reference import tdnn as ref


def run(ctx: harness.Context):
    from xvector_tpu_torch.parallel import launch
    if int(ctx.traffic.get("ranks", 1)) == 1:
        dev = ctx.device or torch.device("cuda", 0)
        return _body(ctx, torch.device(dev), None)
    os.environ["XVBENCH_WORK"] = ctx.work_dir
    os.environ["XVBENCH_T0"] = repr(ctx.t_start)
    out = os.path.join(ctx.work_dir, "result.json")

    def read():
        with open(out) as f:
            return json.load(f)

    return launch.run("xvbench.run", None, ctx.device or "cuda", ctx.work_dir,
                      lambda dev, mesh: _body(ctx, dev, mesh),
                      read_result=read)


def _first_grad_hook(trainer, b1: float, out: Dict):
    """After the optimizer's first step: each leaf's first gradient norm,
    worked out from its first moment (m_1 = (1 - b1) g_1)."""

    def hook(opt, args, kwargs):
        if "norms" in out:
            return
        norms = []
        for p in ref.leaves(trainer.params):
            st = opt.state[p]
            m = next((st[k] for k in ("exp_avg", "m", "mu") if k in st),
                     None)      # no moment kept: nothing was applied
            norms.append(torch.zeros((), device=p.device) if m is None
                         else m.float().norm() / (1.0 - b1))
        out["norms"] = torch.stack(norms)

    return hook


def _body(ctx: harness.Context, dev: torch.device, mesh):
    import torch.distributed as dist
    from xvector_tpu_torch.data import archives as A
    from xvector_tpu_torch.models import tdnn
    from xvector_tpu_torch.parallel import launch
    from xvector_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg, traffic, tc = ctx.cfg, ctx.traffic, ctx.cfg["train"]
    ctx.device = dev
    rank = 0 if mesh is None else mesh.rank
    several = mesh is not None and mesh.size > 1
    cuda = dev.type == "cuda"
    phases = harness.Phases()
    harness.check_preset(cfg, tdnn.MODEL_ZOO[cfg["preset"]])
    lengths = generate.archive_lengths(traffic, ctx.seed)
    paths = [os.path.join(ctx.work_dir, f"egs.{i}.xta")
             for i in range(len(lengths))]
    if rank == 0:
        for i, length in enumerate(lengths):
            x, y = generate.archive_minibatches(traffic, cfg, ctx.seed, i,
                                                length, dev)
            x, y = x.cpu().numpy(), y.to(torch.int32).cpu().numpy()
            A.write_archive(paths[i], [(x[m], y[m], length)
                                       for m in range(x.shape[0])])
            del x, y
            # on disk now, so that no write-back runs in the window
            fd = os.open(paths[i], os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
    if several:
        dist.barrier()
    # the archives were made on the card; from here on the peak is the
    # training job's own (the benchmark's copies stay on the host)
    archive_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    phases.mark("archives")

    tcfg = TrainConfig(model=cfg["preset"], num_targets=cfg["num_targets"],
                       compute_dtype=tc["compute_dtype"],
                       optimizer=tc["optimizer"],
                       initial_effective_lrate=tc["lr"],
                       block_size=tc["block_size"],
                       random_seed=generate.derive(ctx.seed, "trainer")
                       % 2**31)
    trainer = Trainer(tcfg, os.path.join(ctx.work_dir, f"trainer{rank}"),
                      feat_dim=cfg["feat_dim"], device=dev, mesh=mesh)
    phases.mark("trainer")
    params, stats = generate.weights(
        cfg, ctx.seed, dev,
        (lambda flat: dist.broadcast(flat, 0)) if several else None)
    theta0 = [t.detach().to("cpu", copy=True) for t in ref.leaves(params)]
    trainer.set_params(params, stats)
    del params, stats
    phases.mark("weights")

    block = tc["block_size"]
    shapes: List[Tuple[int, int]] = []      # (global rows, frames) fed

    def agreed(flag: bool) -> bool:
        if not several:
            return flag
        t = torch.tensor([float(flag)], device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def feed(archive_ids, stop=None, limit=None):
        """Global minibatches of the archives in turn; ``stop()`` is asked
        at each archive's start; past ``limit`` minibatches of an archive
        the rest is read and dropped, so that its loader's thread ends."""
        for i in archive_ids:
            if stop is not None and agreed(stop()):
                return
            with A.ArchiveReader(paths[i]) as reader:
                for n, (x, y, t) in enumerate(A.PrefetchLoader(reader)):
                    if limit is None or n < limit:
                        shapes.append((x.shape[0], int(t)))
                        yield x, y, t

    def iteration(it, batches):
        return trainer.train_one_iteration(
            it, launch.local_rows(batches, mesh), tc["lr"], 0.0, 1.0)

    # the checked steps: the first check_blocks calls
    opt = trainer.optimizer
    b1 = opt.param_groups[0].get("betas", (opt.param_groups[0].get("b1"),))[0]
    first: Dict = {}
    handle = opt.register_step_post_hook(_first_grad_hook(trainer, b1, first))
    losses = []
    for j in range(traffic["check_blocks"]):
        losses.append(iteration(j, feed([j], limit=block))["loss"])
    handle.remove()
    delta = torch.stack([(p.detach().cpu() - p0).norm() for p, p0 in
                         zip(ref.leaves(trainer.params), theta0)]).tolist()
    grad1 = first["norms"].tolist()
    del theta0
    phases.mark("checked_steps")
    # warm-up: one block of every other length
    for j in range(traffic["check_blocks"], len(paths)):
        iteration(j, feed([j], limit=block))
    phases.mark("warm_up")
    if rank == 0:
        phases.report()

    # the window
    trace_s = float(traffic["trace_seconds"]) if ctx.trace else 0.0
    setup_s = time.time() - ctx.t_start
    w0 = time.perf_counter()
    n0 = len(shapes)
    cycle = itertools.cycle(range(len(paths)))
    deadline_a = w0 + ctx.seconds - trace_s
    stats_a = iteration(1000, feed(
        cycle, stop=lambda: time.perf_counter() >= deadline_a))
    wall_a = time.perf_counter() - w0
    shapes_a = shapes[n0:]
    summary = None
    shapes_b: List[Tuple[int, int]] = []
    if ctx.trace:
        tracer = tr.Tracer(dev)
        tracer.start()
        n1 = len(shapes)
        deadline = tracer.t0 + trace_s
        iteration(1001, feed(
            itertools.cycle(range(len(paths))),
            stop=lambda: time.perf_counter() >= deadline))
        tracer.stop()
        shapes_b = shapes[n1:]
        summary = tracer.summary(tr.load_roles())
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    ranks = mesh.size if mesh is not None else 1
    local = [(math.ceil(r / ranks), t) for r, t in shapes_b]
    mine = {"rank": rank, "peak": peak, "archive_peak": archive_peak,
            "trace": summary,
            "trace_minibatches": local,
            "forbidden": harness.forbidden_modules()}
    del trainer, opt
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    infos = [mine]
    if several:
        with open(os.path.join(ctx.work_dir, f"rank{rank}.json"), "w") as f:
            json.dump(mine, f)
        dist.barrier()
        if rank:
            return None
        infos = []
        for r in range(mesh.size):
            with open(os.path.join(ctx.work_dir, f"rank{r}.json")) as f:
                infos.append(json.load(f))

    numbers = check_numbers(ctx, dev, lengths, losses, grad1, delta)
    audio = sum(r * t for r, t in shapes_a) * work.FRAME_SECONDS
    collected = {
        "cfg": cfg, "chips": ranks,
        "host": {"wall_s": wall_a, "minibatches": len(shapes_a),
                 "upload_wait_s": stats_a.get("upload_wait", 0.0),
                 "dispatch_s": stats_a.get("dispatch", 0.0)},
        "work": {"minibatches": shapes_a},
        "traces": [i["trace"] for i in infos if i["trace"] is not None],
        "trace_minibatches": [i["trace_minibatches"] for i in infos
                              if i["trace"] is not None],
    }
    if summary is not None:
        collected["breakdown"] = tr.breakdown(summary)
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": ranks,
              "memory_peak_bytes": max(max(i["peak"], i["archive_peak"])
                                       for i in infos)}
    if ctx.trace and collected["traces"]:
        ts = collected["traces"]
        device["busy_s"] = sum(t["busy_s"] for t in ts) / len(ts)
        device["window_s"] = summary["window_s"]
    finite = all(math.isfinite(l) for l in losses) and math.isfinite(
        stats_a.get("loss", 0.0))
    checks = harness.verdict(numbers, ctx.limits)
    result = harness.result_line(
        ctx, collected, checks, attempted=len(shapes) - n0,
        failed=0 if finite else len(shapes) - n0, device=device,
        e2e={"setup_s": setup_s,
             "train_peak_memory_gb": max(i["peak"] for i in infos) / 1e9})
    print(f"window train_audio_s_per_s {audio / wall_a!r} wall_s {wall_a!r} "
          f"minibatches {len(shapes_a)}", file=sys.stderr)
    if several:
        # each rank's modules once its window closed, and rank 0's now
        bad = sorted({f"rank {i['rank']}: {m}" for i in infos
                      for m in i["forbidden"]}
                     | {f"rank 0: {m}" for m in harness.forbidden_modules()})
        if bad:
            print("xvbench: forbidden modules loaded: " + ", ".join(bad),
                  file=sys.stderr)
            raise SystemExit(4)
        with open(os.path.join(ctx.work_dir, "result.json"), "w") as f:
            json.dump(result, f)
        return None
    return result


def reference_readings(ctx: harness.Context, dev, lengths, lowp=None,
                       rows: Optional[int] = None, share_rows=None
                       ) -> Dict[str, list]:
    """The reference over the checked steps, from the seed's weights and
    the checked blocks' data: each call's mean loss, each leaf's first
    gradient norm and its change after the checked calls.  ``rows`` keeps
    only that many rows of each minibatch and ``share_rows`` backpropagates
    only the first that many rows' share of the loss (the planted faults of
    the control runs)."""
    cfg, traffic = ctx.cfg, ctx.traffic
    block = cfg["train"]["block_size"]
    params, _ = generate.weights(cfg, ctx.seed, dev)
    theta0 = [t.clone() for t in ref.leaves(params)]
    batches = []
    for j in range(traffic["check_blocks"]):
        x, y = generate.archive_minibatches(traffic, cfg, ctx.seed, j,
                                            lengths[j], dev)
        for m in range(block):
            xb, yb = x[m].to(torch.float32), y[m]
            if rows is not None:
                xb, yb = xb[:rows], yb[:rows]
            batches.append((xb, yb))
        del x, y
    with ref.float32_exact():
        out = ref.train_steps(cfg, params, batches, cfg["train"]["lr"], lowp,
                              share_rows=share_rows)
    losses = out["losses"]
    return {"losses": [sum(losses[i * block:(i + 1) * block]) / block
                       for i in range(traffic["check_blocks"])],
            "grad1": [float(g.norm()) for g in out["first_grad"]],
            "delta": [float((p.detach() - p0).norm()) for p, p0 in
                      zip(ref.leaves(params), theta0)]}


def compare(program: Dict[str, list], reference: Dict[str, list]
            ) -> Dict[str, float]:
    """The numbers of the check: each checked call's loss (``loss_gap``,
    the worst relative gap), the first gradient's norms (``grad_gap`` by
    the worst leaf, ``grad_median`` by the median leaf) and the change's
    norms after the checked calls (``step_gap`` by the worst leaf the
    reference's first gradient moves).  The limits file names the ones
    compared."""
    keep = ref.moved_leaves(reference["grad1"])
    loss_gap = max(abs(p - r) / abs(r) for p, r in
                   zip(program["losses"], reference["losses"]))
    gaps = ref.leaf_gaps(program["grad1"], reference["grad1"])
    return {"loss_gap": ref.finite(loss_gap),
            "grad_gap": ref.finite(max(gaps)),
            "grad_median": ref.finite(sorted(gaps)[len(gaps) // 2]),
            "step_gap": ref.finite(ref.norm_gap(program["delta"],
                                                reference["delta"], keep))}


def report(program: Dict[str, list], reference: Dict[str, list],
           names: List[str]) -> List[str]:
    """Lines that say which leaves read the widest gaps, and the median
    leaf's gap, of the first gradient and of the change."""
    lines = ["losses program " + " ".join(f"{l:.6f}" for l in
                                          program["losses"])
             + " reference " + " ".join(f"{l:.6f}" for l in
                                        reference["losses"])]
    for key in ("grad1", "delta"):
        gaps = ref.leaf_gaps(program[key], reference[key])
        worst = sorted(zip(gaps, names), reverse=True)[:3]
        lines.append(f"{key} median {sorted(gaps)[len(gaps) // 2]:.5f} worst "
                     + " ".join(f"{n}={g:.5f}" for g, n in worst))
    return lines


def check_numbers(ctx, dev, lengths, losses, grad1, delta):
    program = {"losses": losses, "grad1": grad1, "delta": delta}
    reference = reference_readings(ctx, dev, lengths)
    names = generate.param_names(ctx.cfg)
    for line in report(program, reference, names):
        print("leaves " + line, file=sys.stderr)
    return compare(program, reference)
