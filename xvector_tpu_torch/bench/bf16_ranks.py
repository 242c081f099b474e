"""Why a bf16 update on two ranks parts from one process's: controls for
``chip_smoke.py`` phase 16 part A.

    python -m xvector_tpu_torch.bench.bf16_ranks      # from the repo root

On two inputs, part A's (``chip_smoke.write_train_archive`` seed 160,
model seed 165) and phase 15's (seeds 120 and 121), it takes one SGD
step (lr 1e-3, momentum 0.5) at full ``no_dropout`` width from the same
weights, 64x304 minibatch, and compares the updates leaf by leaf (cosine
of the parameter change):

- ``cli.train_dnn`` on 2 gloo ranks sharing the card, twice, and as one
  process, twice (is each run deterministic?);
- the same in f32 (the exact direction), and bf16 with cuBLAS's reduced
  precision bf16 reductions off;
- the trainer called directly, one process and 2 ranks (phase 15's
  ``mc_worker``): does the entry point's path differ from it?
- per leaf, the largest rank's partial gradient norm over the summed
  gradient's (the factor by which rounding each rank's partial sum to
  bf16 could grow the error).

Each line names the two runs compared: the whole update's cosine, the
per-leaf minimum and median and the four lowest leaves.  The first line
is the card's name and power limit.  It exits non-zero without a card;
``XB_DEVICE=cpu`` rehearses it on the CPU (narrow the model first)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# one rank or process of a run of the entry point: SGD, TF32 off,
# optionally without reduced-precision bf16 reductions, and the per-leaf
# gradient norms before and after the all-reduce written to $XB_OUT
CHILD = r'''
import json, os, sys
from functools import partial
import torch
torch.backends.cuda.matmul.allow_tf32 = False
if os.environ.get("XB_NO_RPR"):
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
from xvector_tpu_torch.cli import train_dnn as M
from xvector_tpu_torch.parallel import mesh as meshlib
M.TrainConfig = partial(M.TrainConfig, optimizer="sgd", momentum=0.5)
reduce = meshlib.all_reduce_flat

def recorded(tensors, group):
    local = [t.detach().double().norm().item() for t in tensors]
    out = reduce(tensors, group)
    path = os.path.join(os.environ["XB_OUT"],
                        f"norms_{os.environ.get('XVEC_PROCESS_ID', 0)}.json")
    if group is not None and not os.path.exists(path):
        with open(path, "w") as f:
            json.dump({"local": local,
                       "total": [t.double().norm().item() for t in out]}, f)
    return out

meshlib.all_reduce_flat = recorded
sys.argv = ["train_dnn"] + sys.argv[1:]
M.main()
'''


def _params(work):
    from ..models.convert import tree_leaves
    ck = torch.load(os.path.join(os.path.realpath(
        os.path.join(work, "model_final")), "ckpt.pt"), map_location="cpu",
        weights_only=True)
    return tree_leaves(ck["params"])


def main() -> int:
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke as S

    from ..data import archives as TA
    from ..models import tdnn as tt
    from ..models.convert import tree_leaves
    from ..parallel import launch
    from ..train import checkpoints as C
    from ..train import trainer as TR

    dev = torch.device(os.environ.get("XB_DEVICE", "cuda"))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("bf16_ranks: no CUDA device", file=sys.stderr)
            return 1
        print(S.card_line(), flush=True)
        launch._build_once()
    else:
        launch._build_once = lambda: None
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = tempfile.mkdtemp()
    child = os.path.join(tmp, "child.py")
    with open(child, "w") as f:
        f.write(CHILD)

    def cli(tag, egs, src, dtype, ranks, **extra):
        work = os.path.join(tmp, tag)
        os.makedirs(work)
        shutil.copytree(C.iteration_path(src, 0), C.iteration_path(work, 0))
        flags = ["--model=no_dropout", f"--num-targets={S.TRAIN_CLASSES}",
                 "--num-epochs=1", f"--compute-dtype={dtype}",
                 f"--egs-dir={egs}", f"--dir={work}", "--block-size=2",
                 "--initial-effective-lrate=1e-3",
                 "--final-effective-lrate=1e-3", f"--device={dev.type}"]
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("XVEC_")}
        env.update(PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""),
                   XB_OUT=work, **extra)
        if ranks > 1:
            saved = dict(os.environ)
            os.environ.clear()
            os.environ.update(env, XVEC_BACKEND="gloo")
            try:
                launch.spawn_local_ranks([child, *flags], work, world=ranks,
                                         timeout=300)
            finally:
                os.environ.clear()
                os.environ.update(saved)
        else:
            env["XVEC_NUM_PROCESSES"] = "1"
            subprocess.run([sys.executable, child, *flags], env=env, cwd=REPO,
                           check=True, capture_output=True, timeout=300)
        norms = ([json.load(open(os.path.join(work, f"norms_{r}.json")))
                  for r in range(ranks)] if ranks > 1 else None)
        return _params(work), norms

    for which in ("part A", "phase 15"):
        egs = os.path.join(tmp, f"egs_{which[-1]}")
        os.makedirs(egs)
        if which == "part A":
            x, y, t = S.write_train_archive(
                TA, os.path.join(egs, "egs.0.xta"), 160, 23, full=1,
                ragged=False)[0]
            model_seed = 165
        else:
            rng = np.random.default_rng(120)
            means = rng.standard_normal((S.TRAIN_CLASSES, 23),
                                        dtype=np.float32)
            y = rng.integers(0, S.TRAIN_CLASSES, S.TRAIN_B, dtype=np.int32)
            x = (means[y][:, None, :] + rng.standard_normal(
                (S.TRAIN_B, S.TRAIN_T, 23), dtype=np.float32)
                 ).astype(np.float16)
            t = S.TRAIN_T
            TA.write_archive(os.path.join(egs, "egs.0.xta"), [(x, y, t)])
            model_seed = 121
        _, p0, s0 = S.model(tt, "no_dropout", model_seed, S.TRAIN_CLASSES,
                            "cpu")
        names = S.leaf_names(p0)
        src = os.path.join(tmp, f"m0_{which[-1]}")
        tr = TR.Trainer(S.mc_step_cfg(TR, 0, "float32"), src, device=dev)
        tr._place_all(p0, s0)
        C.save_iteration(tr, 0)
        init = [p.detach().cpu() for p in tree_leaves(tr.params)]
        del tr
        n = len(init)
        res, norms = {}, {}
        runs = [("cli 2 ranks", "bfloat16", 2, {}),
                ("cli 2 ranks again", "bfloat16", 2, {}),
                ("cli 1", "bfloat16", 1, {}),
                ("cli 1 again", "bfloat16", 1, {}),
                ("cli 1 f32", "float32", 1, {}),
                ("cli 2 ranks f32", "float32", 2, {})]
        if which == "part A":
            runs += [("cli 2 ranks no-rpr", "bfloat16", 2, {"XB_NO_RPR": "1"}),
                     ("cli 1 no-rpr", "bfloat16", 1, {"XB_NO_RPR": "1"})]
        for tag, dtype, ranks, extra in runs:
            res[tag], norms[tag] = cli(tag.replace(" ", "_") + which[-1],
                                       egs, src, dtype, ranks, **extra)
        for dtype, tag in (("bfloat16", "direct 1"),
                           ("float32", "direct 1 f32")):
            tr = TR.Trainer(S.mc_step_cfg(TR, 0, dtype),
                            os.path.join(tmp, tag.replace(" ", "_")
                                         + which[-1]), device=dev)
            tr._place_all(p0, s0)
            tr.train_one_iteration(0, iter([(x, y, t)]), 1e-3, 0.0, 1.0)
            res[tag] = [p.detach().cpu() for p in tree_leaves(tr.params)]
            del tr
        _, sp, ss = S.model(tt, "no_dropout", 122, S.TRAIN_CLASSES, "cpu")
        got = S.mc_spawn("parity", 2, "gloo",
                         os.path.join(tmp, f"mc_{which[-1]}"), 0,
                         {"x": x, "y": y, "weights": (p0, s0),
                          "seq_x": np.zeros((S.SEQ_FRAMES, 23), np.float32),
                          "seq_weights": (sp, ss)}, dev)
        res["direct 2 ranks"] = got[0]["bfloat16"]["params"][:n]
        res["direct 2 ranks f32"] = got[0]["float32"]["params"][:n]

        def compare(a, b):
            da = [(p - w).double().flatten() for p, w in zip(res[a], init)]
            db = [(q - w).double().flatten() for q, w in zip(res[b], init)]
            coss = [float(F.cosine_similarity(u, v, dim=0))
                    for u, v in zip(da, db)]
            whole = float(F.cosine_similarity(torch.cat(da), torch.cat(db),
                                              dim=0))
            low = np.argsort(coss)[:4]
            print(f"{which}: {a} vs {b}: whole {whole:.6f}, per leaf min "
                  f"{min(coss):.5f} median {np.median(coss):.5f}; "
                  + ", ".join(f"{names[i]} {coss[i]:.4f}" for i in low),
                  flush=True)

        pairs = [("cli 2 ranks", "cli 2 ranks again"),
                 ("cli 1", "cli 1 again"), ("cli 2 ranks", "cli 1"),
                 ("cli 2 ranks", "cli 1 f32"), ("cli 1", "cli 1 f32"),
                 ("cli 2 ranks f32", "cli 1 f32"), ("direct 1", "cli 1"),
                 ("direct 1 f32", "cli 1 f32"),
                 ("direct 2 ranks", "cli 2 ranks"),
                 ("direct 2 ranks", "direct 1"),
                 ("direct 2 ranks f32", "direct 1 f32")]
        if which == "part A":
            pairs += [("cli 2 ranks no-rpr", "cli 1 no-rpr"),
                      ("cli 2 ranks no-rpr", "cli 2 ranks")]
        for a, b in pairs:
            compare(a, b)
        nr = norms["cli 2 ranks"]
        ratio = [max(r["local"][i] for r in nr) / max(nr[0]["total"][i],
                                                      1e-30)
                 for i in range(n)]
        top = np.argsort(ratio)[::-1][:4]
        print(f"{which}: cli 2 ranks, largest partial gradient norm over the "
              f"summed one per leaf: median {np.median(ratio):.3g}, largest "
              + ", ".join(f"{names[i]} {ratio[i]:.3g}" for i in top),
              flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
