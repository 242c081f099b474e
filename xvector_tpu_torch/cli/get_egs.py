"""Training-archive generation CLI with the reference's flag surface.

``local/tf/get_egs.sh [opts] <data> <egs-dir>`` (reference
``get_egs.sh:54-80``) turned a feature data dir into chunk-allocation
plans + materialised tar archives; here the same contract produces XTA
archives: ``egs.N.xta``, diagnostic ``valid_egs.xta`` /
``train_subset_egs.xta``, ``pdf2num``, and the ``info/`` files the
reference trainer validates (``ze_utils.py:56-73``).

The data dir must hold ``utt2spk`` + ``feats.scp`` (and optionally
``vad.scp``) in Kaldi format — exactly what :mod:`cli.run`'s feature
stage or an external Kaldi front-end writes.

Counterpart of ``xvector_tpu/cli/get_egs.py``, with the same flags plus
``--device`` (where sliding CMVN runs; default cuda).  Archives come from
libxta's native materialisation where a compiler is present; the
port's ``cli.train_dnn --egs-dir`` trains from them.
"""

from __future__ import annotations

import argparse
import glob
import os

from ..data import allocator as alloclib
from ..data import archives as archlib
from ..io.datadir import load_data_dir
from .run import Recipe, RecipeConfig


def get_args(argv=None):
    p = argparse.ArgumentParser(
        description="generate training archives (get_egs.sh contract)")
    p.add_argument("--min-frames-per-chunk", type=int, default=200)
    p.add_argument("--max-frames-per-chunk", type=int, default=400)
    p.add_argument("--minibatch-size", type=int, default=64)
    p.add_argument("--num-repeats", type=int, default=35)
    p.add_argument("--frames-per-iter", type=float, default=1e9)
    p.add_argument("--num-train-archives", type=int, default=0,
                   help="0 = derive from total frames "
                        "(get_egs.sh:120 formula)")
    p.add_argument("--num-heldout-utts", type=int, default=200)
    p.add_argument("--accepted-overlap", type=float, default=0.2)
    p.add_argument("--random-seed", type=int, default=2468)
    p.add_argument("--allocation-strategy", default="per_archive",
                   choices=["per_archive", "kaldi_original", "whole"],
                   help="per_archive = the reference's active "
                        "our_splitting_per_archive; the other two are its "
                        "dormant allocators (create_egs.py:285-474)")
    p.add_argument("--randomize-chunk-length", default="true",
                   choices=["true", "false"],
                   help="false = geometric deterministic ladder "
                        "(create_egs.py:223-231)")
    p.add_argument("--min-utt-frames", type=int, default=0,
                   help="drop utterances with <= this many voiced frames "
                        "before allocation (strict '>', the run.sh:199 "
                        "awk semantics)")
    p.add_argument("--min-spk-utts", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="where sliding CMVN runs (cuda, or cpu)")
    p.add_argument("data_dir")
    p.add_argument("egs_dir")
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)

    alloc = alloclib.AllocatorConfig(
        min_frames=args.min_frames_per_chunk,
        max_frames=args.max_frames_per_chunk,
        minibatch_size=args.minibatch_size,
        num_repeats=args.num_repeats,
        frames_per_iter=int(args.frames_per_iter),
        accepted_overlap=args.accepted_overlap,
        seed=args.random_seed,
        strategy=args.allocation_strategy,
        length_strategy=("random" if args.randomize_chunk_length == "true"
                         else "deterministic"))
    cfg = RecipeConfig(work_dir=args.egs_dir, allocator=alloc,
                       num_archives=args.num_train_archives or None,
                       num_valid_utts=args.num_heldout_utts,
                       min_utt_frames=args.min_utt_frames,
                       min_spk_utts=args.min_spk_utts,
                       device=args.device)
    recipe = Recipe(cfg)
    data = load_data_dir(args.data_dir)
    if not data.feats:
        raise SystemExit(f"{args.data_dir} has no feats.scp; run the "
                         "feature stage first")
    train, valid, num_targets = recipe.make_egs(data)

    # info/ contract (egs-dir validation, ze_utils.py:56-73)
    info = os.path.join(args.egs_dir, "info")
    os.makedirs(info, exist_ok=True)
    with archlib.ArchiveReader(
            os.path.join(args.egs_dir, "egs.0.xta")) as first:
        feat_dim = int(first.index[0]["shape"][2])
    n_arch = len(glob.glob(os.path.join(args.egs_dir, "egs.*.xta")))
    for name, value in (("feat_dim", feat_dim),
                        ("num_archives", n_arch),
                        ("num_targets", num_targets)):
        with open(os.path.join(info, name), "w") as f:
            f.write(f"{value}\n")
    print(f"wrote {n_arch} archives, {num_targets} targets "
          f"({len(train)} train / {len(valid)} valid utts) "
          f"-> {args.egs_dir}")


if __name__ == "__main__":
    main()
