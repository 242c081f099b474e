"""Diagnostics evaluator CLI: loss/accuracy of a checkpoint on a
diagnostic archive.

Counterpart of ``xvector_tpu/cli/eval_dnn.py`` (the reference's
``eval_dnn.py:89-101``): probes a saved checkpoint after the fact and
prints one JSON line ``{"egs": ..., "loss": ..., "accuracy": ...}``.
``--device`` (default ``cuda``) picks the device.  On a host with several
visible cards it evaluates data-parallel on all of them, as the JAX
package does on every local chip (``parallel/launch.run``): each rank
feeds its rows of each minibatch, the eval step sums loss and accuracy
over the ranks, and rank 0 alone prints.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..data import archives as archlib
from ..models.tdnn import MODEL_ZOO, REFERENCE_CLASS_TO_PRESET
from ..parallel import launch
from ..train import checkpoints
from ..train.trainer import TrainConfig, Trainer


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model-dir", required=True,
                   help="iteration dir (model_N) or trainer work dir "
                        "(uses model_final)")
    p.add_argument("--model", default="ModelWithoutDropout")
    p.add_argument("--num-targets", type=int, required=True)
    p.add_argument("--egs", required=True,
                   help="diagnostic archive: .xta, or a reference-format "
                        ".tar (examples_io.py layout; labels .npy beside "
                        "it)")
    p.add_argument("--feat-dim", type=int, default=23)
    p.add_argument("--compute-dtype", default="float32")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    preset = REFERENCE_CLASS_TO_PRESET.get(args.model, args.model)
    if preset not in MODEL_ZOO:
        sys.exit(f"unknown model {args.model!r}")
    target = args.model_dir
    is_iter_dir = os.path.basename(target).startswith("model_")
    work_dir = os.path.dirname(target) if is_iter_dir else target
    if not is_iter_dir and checkpoints.latest_complete(target) is None \
            and not os.path.exists(os.path.join(target, "model_final")):
        sys.exit(f"no checkpoint under {target}")
    cfg = TrainConfig(model=preset, num_targets=args.num_targets,
                      compute_dtype=args.compute_dtype)

    def evaluate(device, mesh):
        trainer = Trainer(cfg, work_dir, feat_dim=args.feat_dim,
                          device=device, mesh=mesh)
        if is_iter_dir:
            checkpoints.restore_into(trainer, target)
        else:
            final = os.path.join(target, "model_final")
            if os.path.exists(final):
                checkpoints.restore_into(trainer, os.path.realpath(final))
            else:
                # model_0 (the initial-parameters save) counts: a run that
                # crashed in iteration 0 is still evaluable
                checkpoints.restore_latest(trainer)

        if args.egs.endswith(".tar"):
            from ..data.reference_tar import read_reference_tar
            # streamed: evaluate() reads it once
            loader = ((mat, lab, int(mat.shape[1]))
                      for mat, lab in read_reference_tar(args.egs))
        else:
            loader = archlib.PrefetchLoader(archlib.ArchiveReader(args.egs))
        stats = trainer.evaluate(launch.local_rows(loader, mesh))
        if mesh is None or mesh.rank == 0:
            print(json.dumps({"egs": args.egs, **stats}))
        return stats

    return launch.run("xvector_tpu_torch.cli.eval_dnn", argv, args.device,
                      work_dir, evaluate)


if __name__ == "__main__":
    main()
