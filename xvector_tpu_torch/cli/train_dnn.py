"""Training CLI with reference-compatible flag spellings.

Counterpart of ``xvector_tpu/cli/train_dnn.py``, the drop-in-shaped
replacement for the reference's ``train_dnn.py`` (``:29-184``): the flags
keep their Kaldi spellings (``--tf-model-class``,
``--initial-effective-lrate``, ``--num-epochs``, ``--egs-dir``, ``--dir``
…) and drive :class:`~..train.trainer.Trainer` over the XTA archives
``egs.*.xta`` of ``--egs-dir`` (diagnostics from ``valid_egs.xta`` and
``train_subset_egs.xta`` when present), under
:class:`~..train.preemption.GracefulPreemption`, then write
``accuracy.report`` from ``metrics.jsonl``.  ``--device`` (default
``cuda``) picks the device; without a card a ``cuda`` run raises.

Like the JAX package's, which trains on every local chip, it trains
data-parallel on every visible card, one rank per card under NCCL
(``parallel/launch.run``; ``CUDA_VISIBLE_DEVICES`` picks the cards): each
rank reads whole archives and feeds its rows of each minibatch, and rank 0
alone writes the report and prints the summary.  One visible card, or
``--device=cpu``, is one process.

    python -m xvector_tpu_torch.cli.train_dnn --model=no_dropout \\
        --num-targets=7185 --egs-dir=EGS --dir=EXP --device=cuda
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

from ..data import archives as archlib
from ..models.tdnn import MODEL_ZOO, REFERENCE_CLASS_TO_PRESET
from ..parallel import launch
from ..train.preemption import GracefulPreemption
from ..train.trainer import TrainConfig, Trainer
from ..utils.scores import generate_report


def str2bool(v: str) -> bool:
    return v.lower() in ("true", "yes", "1")


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tf-model-class", "--model", dest="model",
                   default="ModelWithoutDropout",
                   help="reference TF class name or preset name")
    p.add_argument("--num-targets", type=int, required=True)
    p.add_argument("--initial-effective-lrate", type=float, default=1e-3)
    p.add_argument("--final-effective-lrate", type=float, default=1e-4)
    p.add_argument("--num-epochs", type=int, default=2)
    p.add_argument("--dropout-schedule", default="0,0@0.10,0.1@0.50,0")
    p.add_argument("--proportional-shrink", type=float, default=0.0)
    p.add_argument("--apply-shrink", type=str2bool, default=False)
    p.add_argument("--momentum", type=float, default=0.0,
                   help="parsed for compatibility; Adam ignores it as in "
                        "the reference (models.py:518)")
    p.add_argument("--max-param-change", type=float, default=0.0)
    p.add_argument("--minibatch-size", type=int, default=64)
    p.add_argument("--random-seed", type=int, default=2468)
    p.add_argument("--preserve-model-interval", type=int, default=10)
    p.add_argument("--head", default="softmax",
                   choices=("softmax", "am_softmax"))
    p.add_argument("--compute-dtype", default="bfloat16")
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--stage", type=int, default=0,
                   help="first iteration to (re)run; completed iterations "
                        "are skipped automatically")
    p.add_argument("--egs-dir", required=True)
    p.add_argument("--dir", dest="work_dir", required=True)
    p.add_argument("--feat-dim", type=int, default=0,
                   help="0 = infer from the first archive")
    p.add_argument("--do-final-combination", type=str2bool, default=False,
                   help="fit combination weights over the last iterations' "
                        "checkpoints (the reference parses this flag but "
                        "raises if set, train_dnn.py:571-581)")
    p.add_argument("--max-models-combine", type=int, default=20)
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda (the default) raises without a "
                        "card, cpu runs the plain versions of the kernels")
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    preset = REFERENCE_CLASS_TO_PRESET.get(args.model, args.model)
    if preset not in MODEL_ZOO:
        sys.exit(f"unknown model {args.model!r}; presets: "
                 f"{sorted(MODEL_ZOO)} or reference classes: "
                 f"{sorted(REFERENCE_CLASS_TO_PRESET)}")
    cfg = TrainConfig(
        model=preset, num_targets=args.num_targets,
        initial_effective_lrate=args.initial_effective_lrate,
        final_effective_lrate=args.final_effective_lrate,
        num_epochs=args.num_epochs,
        dropout_schedule=args.dropout_schedule,
        proportional_shrink=args.proportional_shrink,
        apply_shrink=args.apply_shrink,
        random_seed=args.random_seed, head=args.head,
        preserve_model_interval=args.preserve_model_interval,
        compute_dtype=args.compute_dtype,
        max_param_change=args.max_param_change,
        block_size=args.block_size,
        final_combine=args.do_final_combination,
        max_models_combine=args.max_models_combine)

    paths = sorted(glob.glob(os.path.join(args.egs_dir, "egs.*.xta")))
    if not paths:
        sys.exit(f"no egs.*.xta archives in {args.egs_dir}")
    feat_dim = args.feat_dim
    if feat_dim <= 0:   # infer from the archive index (feat-to-dim parity)
        with archlib.ArchiveReader(paths[0]) as r:
            feat_dim = int(r.index[0]["shape"][2])

    def train(device, mesh):
        def archive_batches(i):
            return launch.local_rows(
                archlib.PrefetchLoader(archlib.ArchiveReader(paths[i])),
                mesh)

        def diag(name):
            p = os.path.join(args.egs_dir, name)
            if not os.path.exists(p):
                return None
            return lambda: launch.local_rows(
                archlib.PrefetchLoader(archlib.ArchiveReader(p)), mesh)

        trainer = Trainer(cfg, args.work_dir, feat_dim=feat_dim,
                          device=device, mesh=mesh)
        # SIGTERM stops at the next safe point (every rank at the same
        # one); the per-iteration checkpoint makes a rerun resume exactly
        with GracefulPreemption() as pre:
            final = trainer.train(
                archive_batches, len(paths),
                valid_batches=diag("valid_egs.xta"),
                train_subset_batches=diag("train_subset_egs.xta"),
                start_iter=args.stage, preemption=pre)
        if mesh is not None and mesh.rank:
            return
        report = generate_report(os.path.join(args.work_dir,
                                              "metrics.jsonl"))
        with open(os.path.join(args.work_dir, "accuracy.report"), "w") as f:
            f.write(report)
        if final < cfg.num_epochs * len(paths):
            print(f"preempted after {final} complete iterations -> "
                  f"{args.work_dir} (rerun to resume)")
        else:
            print(f"trained {final} iterations -> "
                  f"{args.work_dir}/model_final")

    launch.run("xvector_tpu_torch.cli.train_dnn", argv, args.device,
               args.work_dir, train)


if __name__ == "__main__":
    main()
