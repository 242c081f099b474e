"""Rank bodies of the port's multi-process CPU tests
(``tests/test_torch_parallel.py``, ``tests/test_torch_multiprocess.py``).

Run as ``python torch_dist_workers.py <group> <rank> <world> <init file or
tcp:// address> <inputs.pkl> <out dir>``: the rank joins a gloo group
through the file store or the address (on ``inputs["device"]``, the CPU
by default: the card's groups put every rank on ``cuda:0``), computes the cases of ``<group>`` on the inputs
the test pickled (or makes from a seed), and pickles its results as
``<out dir>/<group>_<rank>.pkl``.  Group ``cli`` joins nothing itself: it
runs an entry point's ``main`` as one rank under the launch contract
(``XVEC_*`` variables, gloo; ``tests/test_torch_entry_multirank.py``).
Imports the port, never JAX.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import io
import os
import pickle
import signal
import sys
from dataclasses import replace

import numpy as np
import torch

from xvector_tpu_torch.models import heads as TH
from xvector_tpu_torch.models import tdnn as tt
from xvector_tpu_torch.models.convert import (gather_params,
                                              params_from_numpy,
                                              shard_params, tree_leaves)
from xvector_tpu_torch.parallel import launch, seqshard
from xvector_tpu_torch.parallel import mesh as meshlib

NUM_SPK, FEAT = 8, 23


def np_tree(tree):
    return (tree.detach().numpy() if isinstance(tree, torch.Tensor)
            else {k: np_tree(v) for k, v in tree.items()}
            if isinstance(tree, dict)
            else type(tree)(np_tree(v) for v in tree)
            if isinstance(tree, (list, tuple)) else tree)


def head_inputs():
    """``tests/test_sharded_head.py``'s fixture, draw for draw."""
    rng = np.random.RandomState(0)
    b, d, c = 16, 32, 64
    return (rng.randn(b, d).astype(np.float32),
            (rng.randn(d, c) * 0.1).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32),
            rng.randint(0, c, b).astype(np.int32))


def bn_inputs(seed=0, b=8, t=20, c=16):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t, c).astype(np.float32) * 2 + 0.5
    lens = rng.randint(t // 2, t + 1, b)
    mask = (np.arange(t)[None] < lens[:, None]).astype(np.float32)
    a, w = rng.randn(2, c).astype(np.float32)
    return x, mask, a, w


def train_inputs(seed=1, b=8, t=40):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t, FEAT).astype(np.float32)
    y = rng.randint(0, NUM_SPK, b).astype(np.int64)
    mask = np.ones((b, t), np.float32)
    mask[:, t - 7:] = 0.0
    weight = np.ones(b, np.float32)
    weight[-1] = 0.0                # one pad row
    return x, y, mask, weight


def rows(a, mesh):
    lo, hi = launch.host_local_batch_slice(a.shape[0], mesh)
    return torch.from_numpy(np.ascontiguousarray(a[lo:hi]))


# ---------------------------------------------------------------------------
# groups
# ---------------------------------------------------------------------------

def group_heads(rank, world, inputs):
    """model = world: the sharded head's four cases, and the head's
    columns split and gathered."""
    mesh = meshlib.make_mesh(data=1, model=world, device="cpu")
    h, w, b, y = (torch.from_numpy(a) for a in head_inputs())
    out = {}
    ce, acc = TH.sharded_softmax_ce(h, w, b, y, mesh)
    out["ce"], out["acc"] = float(ce), float(acc)
    rw = torch.tensor([1.0] * 12 + [0.0] * 4)
    ce, acc = TH.sharded_softmax_ce(h, w, b, y, mesh, row_weight=rw)
    out["ce_rw"], out["acc_rw"] = float(ce), float(acc)
    hg, wg, bg = (t.clone().requires_grad_(True) for t in (h, w, b))
    TH.sharded_softmax_ce(hg, wg, bg, y, mesh)[0].backward()
    out["grads"] = [t.grad.numpy() for t in (hg, wg, bg)]
    try:
        TH.sharded_softmax_ce(h, w[:, :63], b[:63], y, mesh)
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    params, state = params_from_numpy(*inputs["tiny"], device="cpu")
    local = shard_params(params, mesh)
    out["local_head"] = np_tree(local["output"])
    out["regathered"] = np_tree(gather_params(local, mesh))
    return out


def group_data(rank, world, inputs):
    """data = world: global batch-norm moments, a train-mode forward and
    backward, sequence-sharded x-vectors, launch's row and archive
    shares, and the mesh's layouts and collectives."""
    mesh = meshlib.make_mesh(data=world, model=1, device="cpu")
    g = mesh.data_group
    out = {"coords": (mesh.data_index, mesh.model_index, mesh.size)}

    # batch-norm moments over the ranks' rows; each rank's loss is its
    # share (1/world) of the objective, whose gradient the backward of
    # the moments' all-reduce sums
    x, mask, a, wv = bn_inputs()
    for centered in (True, False):
        xl = rows(x, mesh).requires_grad_(True)
        mean, var = tt._masked_moments(xl, rows(mask, mesh)[..., None],
                                       (0, 1), centered=centered, group=g)
        ((mean * torch.from_numpy(a)).sum() + (var * torch.from_numpy(wv))
         .sum()).div(world).backward()
        out[f"moments_{centered}"] = (mean.detach().numpy(),
                                      var.detach().numpy(),
                                      xl.grad.numpy())

    # train-mode apply: loss = the global mean CE (replicated, identity
    # backward), gradients summed over the ranks as the trainer does; in
    # float64, where only a mis-scaled collective can part the ranks from
    # one process (in f32 the CPU's matmul blocking differs between 2 and
    # 8 rows by a few ulps)
    cfg = tt.MODEL_ZOO["tiny"]
    params, state = params_from_numpy(*inputs["tiny"], device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    x, y, m, wt = train_inputs()
    for masked in (True, False):
        xl = rows(x.astype(np.float64), mesh).requires_grad_(True)
        res = tt.apply(cfg, params, state, xl,
                       mask=rows(m, mesh) if masked else None,
                       row_weight=rows(wt, mesh) if masked else None,
                       train=True, group=g, compute_dtype=torch.float64)
        loss = TH.softmax_ce(res["logits"], rows(y, mesh),
                             rows(wt, mesh) if masked else None, g)
        grads = torch.autograd.grad(loss, [xl] + tree_leaves(params))
        pg = meshlib.all_reduce_flat(list(grads[1:]), g)
        out[f"apply_{masked}"] = (float(loss), res["hidden"].detach().numpy(),
                                  np_tree(res["state"]), grads[0].numpy(),
                                  [t.numpy() for t in pg])

    # sequence-sharded x-vectors (tests/test_seqshard.py's cases)
    for name, (cfg_fields, params_np, state_np, xs, valid) in \
            inputs["seqshard"].items():
        c = replace(tt.MODEL_ZOO[cfg_fields.pop("preset")], **cfg_fields)
        p, s = params_from_numpy(params_np, state_np, device="cpu")
        try:
            out[f"seq_{name}"] = seqshard.seq_sharded_xvector(
                c, p, s, xs, mesh, valid_len=valid).numpy()
        except ValueError as e:
            out[f"seq_{name}"] = str(e)

    # launch's shares of rows and archives
    out["launch"] = {
        "slice64": launch.host_local_batch_slice(64),
        "slice64_mesh": launch.host_local_batch_slice(64, mesh),
        "archives5": launch.shard_archives(5),
        "archives3": launch.shard_archives(3),
        "coordinator": launch.is_coordinator()}
    try:
        launch.host_local_batch_slice(63)
        out["launch"]["slice63"] = None
    except ValueError as e:
        out["launch"]["slice63"] = str(e)

    # layouts and collectives
    xb = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    out["put_batch"] = meshlib.put_batch(
        xb, meshlib.batch_sharding(mesh)).numpy()
    mine = {"a": torch.full((3,), float(rank)), "b": [torch.ones(2) * rank]}
    out["put_global"] = np_tree(meshlib.put_global(
        mine, meshlib.replicated(mesh)))
    out["gather"] = meshlib.gather_dim(torch.full((2, 1), float(rank)), 1,
                                       g).numpy()
    out["max"] = meshlib.all_reduce_max(torch.tensor([rank, -rank]),
                                        g).numpy()
    return out


def scaling_batches(n=4, mb=16, t=64, seed=0):
    """``tests/test_scaling.py``'s minibatches (``tests/test_multiprocess.py``
    draws the same way at mb=8)."""
    rng = np.random.RandomState(seed)
    means = rng.randn(NUM_SPK, FEAT) * 2.0
    out = []
    for _ in range(n):
        y = rng.randint(0, NUM_SPK, mb).astype(np.int32)
        x = (rng.randn(mb, t, FEAT) * 0.3
             + means[y][:, None, :]).astype(np.float16)
        out.append((x, y, t))
    return out


def _local(batches, mesh):
    out = []
    for x, y, t in batches:
        lo, hi = launch.host_local_batch_slice(x.shape[0], mesh)
        out.append((x[lo:hi], y[lo:hi], t))
    return out


def _trainer(inputs, tag, mesh, **fields):
    """A tiny trainer (f32 unless ``fields`` say otherwise) in a work dir
    the ranks share, from the test's numpy weights."""
    from xvector_tpu_torch.train.trainer import TrainConfig, Trainer
    tr = Trainer(TrainConfig(**{**dict(num_targets=NUM_SPK, model="tiny",
                                       compute_dtype="float32",
                                       block_size=2), **fields}),
                 os.path.join(inputs["work"], tag),
                 device=inputs.get("device", "cpu"), mesh=mesh)
    tr._place_all(*params_from_numpy(*inputs["tiny"], device="cpu"))
    return tr


def group_steps(rank, world, inputs):
    """world = 4: one SGD iteration on a data = 4 mesh; three Adam
    iterations on data = 4 with the dense head and on data 2 × model 2 with
    the sharded head, then the sharded run's checkpoint."""
    from xvector_tpu_torch.train import checkpoints
    data4 = meshlib.make_mesh(data=world, model=1, device="cpu")
    dm = meshlib.make_mesh(data=world // 2, model=2, device="cpu")
    out = {}
    tr = _trainer(inputs, "sgd", data4, optimizer="sgd", momentum=0.5)
    st = tr.train_one_iteration(0, iter(_local(scaling_batches(n=2), data4)),
                                lr=1e-3, dropout=0.0, shrink=1.0)
    out["sgd"] = (st["loss"], np_tree(tr.params), np_tree(tr.state))
    for tag, mesh, head in (("dp", data4, "softmax"),
                            ("mp", dm, "sharded_softmax")):
        tr = _trainer(inputs, tag, mesh, head=head)
        for it in range(3):
            st = tr.train_one_iteration(
                it, iter(_local(scaling_batches(), mesh)), lr=1e-3,
                dropout=0.0, shrink=1.0)
        out[tag] = (st["loss"], np_tree(gather_params(tr.params, mesh)))
        if tag == "mp":
            out["mp_local"] = np_tree(tr.params)
            checkpoints.save_iteration(tr, 3)
    return out


def group_two(rank, world, inputs):
    """world = 2: ``tests/test_multiprocess.py``'s two-process iteration."""
    mesh = meshlib.make_mesh(data=world, model=1, device="cpu")
    tr = _trainer(inputs, "two", mesh)
    st = tr.train_one_iteration(0, iter(_local(scaling_batches(mb=8), mesh)),
                                lr=1e-3, dropout=0.0, shrink=1.0)
    w = tr.params["embed"][0]["w"].detach().numpy()
    return {"loss": st["loss"], "accuracy": st["accuracy"],
            "checksum": float(np.sum(np.abs(w))), "w00": float(w[0, 0])}


def group_cuda_step(rank, world, inputs):
    """world = 2 on one card: one bf16 SGD step through K2-K4 on each
    rank's rows (``tests/test_torch_cuda.py``)."""
    from xvector_tpu_torch.ops import conv_bwd as CB
    mesh = meshlib.make_mesh(data=world, model=1, device=inputs["device"])
    tr = _trainer(inputs, "cuda_step", mesh, compute_dtype="bfloat16",
                  optimizer="sgd", momentum=0.5)
    before = dict(CB.route_launches)
    st = tr.train_one_iteration(0, iter(_local(inputs["batches"], mesh)),
                                lr=1e-3, dropout=0.0, shrink=1.0)
    return {"loss": st["loss"],
            "params": [p.detach().cpu() for p in tree_leaves(tr.params)],
            "routes": {k: v - before[k]
                       for k, v in CB.route_launches.items()}}


def group_cuda_sharded(rank, world, inputs):
    """data 1 × model ``world`` on one card: one f32 SGD step of the
    sharded head (``tests/test_torch_cuda.py``)."""
    mesh = meshlib.make_mesh(data=1, model=world, device=inputs["device"])
    tr = _trainer(inputs, "cuda_sharded", mesh, head="sharded_softmax",
                  optimizer="sgd", momentum=0.5,
                  num_targets=inputs["num_targets"])
    st = tr.train_one_iteration(0, iter(inputs["batches"]), lr=1e-3,
                                dropout=0.0, shrink=1.0)
    return {"loss": st["loss"],
            "params": [p.detach().cpu() for p in
                       tree_leaves(gather_params(tr.params, mesh))]}


def group_coord(rank, world, inputs):
    """world = 2 over one work dir: only the mesh's coordinator deletes old
    iterations (``shutil.rmtree`` watched on every rank); then rank 0 alone
    trains, saves and marks ``model_final`` with a trainer built without a
    mesh, while rank 1 waits for its flag file outside any collective."""
    import shutil
    import time
    from xvector_tpu_torch.train import checkpoints
    mesh = meshlib.make_mesh(data=world, model=1, device="cpu")
    work = os.path.join(inputs["work"], "gc")
    if rank == 0:
        for it in range(1, 6):
            os.makedirs(os.path.join(work, f"model_{it}"))
    meshlib.barrier(mesh.world_group)
    deleted, rmtree = [], shutil.rmtree

    def watched(path, *args, **kwargs):
        deleted.append(os.path.basename(path))
        return rmtree(path, *args, **kwargs)

    shutil.rmtree = watched
    try:
        checkpoints.collect_garbage(work, 5, 0, mesh=mesh)
    finally:
        shutil.rmtree = rmtree
    checkpoints.mark_final(work, 5, mesh)
    out = {"deleted": deleted, "left": sorted(os.listdir(work)),
           "final": os.readlink(os.path.join(work, "model_final"))}
    flag = os.path.join(inputs["work"], "solo_done")
    if rank == 0:
        tr = _trainer(inputs, "solo", None, optimizer="sgd", momentum=0.5)
        st = tr.train_one_iteration(0, iter(scaling_batches(n=2, mb=8)),
                                    lr=1e-3, dropout=0.0, shrink=1.0)
        checkpoints.save_iteration(tr, 1)
        checkpoints.collect_garbage(tr.work_dir, 1, 0, mesh=tr.mesh)
        checkpoints.mark_final(tr.work_dir, 1, tr.mesh)
        out["solo"] = {"size": tr.mesh.size, "loss": st["loss"],
                       "params": np_tree(tr.params),
                       "done": checkpoints.is_complete(
                           checkpoints.iteration_path(tr.work_dir, 1)),
                       "final": os.readlink(os.path.join(tr.work_dir,
                                                         "model_final"))}
        open(flag, "w").close()
    else:
        deadline = time.monotonic() + 80
        while not os.path.exists(flag):
            if time.monotonic() > deadline:
                raise TimeoutError("rank 0's one-process trainer never "
                                   "finished")
            time.sleep(0.05)
    meshlib.barrier(mesh.world_group)
    return out


def group_tcp(rank, world, inputs):
    """A group joined through ``tcp://``: one all-reduce."""
    t = torch.tensor([rank + 1.0])
    torch.distributed.all_reduce(t)
    return {"sum": float(t), "world": torch.distributed.get_world_size()}


def group_pad3(rank, world, inputs):
    """world = 3: one SGD iteration on 8-row minibatches, which the data
    axis does not divide (``launch.local_rows`` pads them to 9 with a
    weight-0 row); then ``launch.Rank0Stage`` handing rank 0's result to
    every rank, and rank 0's failure inside a stage to every rank."""
    mesh = meshlib.make_mesh(data=world, model=1, device="cpu")
    tr = _trainer(inputs, "pad3", mesh, optimizer="sgd", momentum=0.5)
    batches = scaling_batches(n=2, mb=8)
    st = tr.train_one_iteration(0, launch.local_rows(iter(batches), mesh),
                                lr=1e-3, dropout=0.0, shrink=1.0)
    out = {"sgd": (st["loss"], np_tree(tr.params), np_tree(tr.state)),
           "rows": [item[0].shape[0] for item in
                    launch.local_rows(iter(batches), mesh)]}
    with launch.Rank0Stage(mesh, inputs["work"], "stage") as stage:
        if stage.runs_here:
            stage.result = {"from": rank}
    out["stage"] = stage.result
    try:
        with launch.Rank0Stage(mesh, inputs["work"], "failing") as stage:
            if stage.runs_here:
                raise ValueError("rank 0's stage failed")
        out["failing"] = None
    except (ValueError, RuntimeError) as e:
        out["failing"] = f"{type(e).__name__}: {e}"
    return out


def cli_rank(rank, world, init, inputs):
    """One rank of an entry point (``inputs["module"]``'s ``main`` on
    ``inputs["argv"]``) under the launch contract, over gloo.  Optional:
    ``sgd`` (the CLI's ``TrainConfig`` made SGD with momentum 0.5, for
    strict parity), ``sigterm`` ({rank: k}: that rank sends itself SIGTERM
    as the trainer takes its k-th minibatch, counted from 0 over the
    run)."""
    os.environ.update(XVEC_COORDINATOR=init, XVEC_NUM_PROCESSES=str(world),
                      XVEC_PROCESS_ID=str(rank), XVEC_BACKEND="gloo")
    module = importlib.import_module(inputs["module"])
    if inputs.get("sgd"):
        module.TrainConfig = functools.partial(module.TrainConfig,
                                               optimizer="sgd", momentum=0.5)
    kill_at = inputs.get("sigterm", {}).get(rank)
    if kill_at is not None:
        rows, count = launch.local_rows, [0]

        def counted(batches, mesh):
            for item in rows(batches, mesh):
                if count[0] == kill_at:
                    os.kill(os.getpid(), signal.SIGTERM)
                count[0] += 1
                yield item

        launch.local_rows = counted
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = module.main(inputs["argv"])
    return {"stdout": buf.getvalue(), "result": result,
            "imported": sorted(m for m in ("jax", "xvector_tpu")
                               if m in sys.modules)}


GROUPS = {"pad3": group_pad3, "heads": group_heads, "coord": group_coord,
          "tcp": group_tcp, "data": group_data,
          "steps": group_steps, "two": group_two,
          "cuda_step": group_cuda_step, "cuda_sharded": group_cuda_sharded}


def run(group, world, inputs, tmp, timeout=100, init=None, tag=""):
    """Spawn ``group``'s ranks on ``inputs`` (pickled into ``tmp``) and
    return their results, rank by rank; a hung group is killed at
    ``timeout`` seconds.  The ranks meet through a store file in ``tmp``,
    or at ``init`` (a ``tcp://`` address) where it is given; ``tag`` names
    one of several runs of a group in ``tmp``."""
    from xvector_tpu_torch.parallel import mc_harness
    tmp = str(tmp)
    group_dir = os.path.join(tmp, group + tag)
    os.makedirs(group_dir, exist_ok=True)
    inputs_path = os.path.join(group_dir, "inputs.pkl")
    with open(inputs_path, "wb") as f:
        pickle.dump(inputs, f)
    mc_harness.spawn(os.path.abspath(__file__), [
        [group, r, world, init or os.path.join(group_dir, "rdv"),
         inputs_path, group_dir] for r in range(world)], timeout=timeout)
    out = []
    for r in range(world):
        with open(os.path.join(group_dir, f"{group}_{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def main(argv):
    group, rank, world = argv[0], int(argv[1]), int(argv[2])
    init, inputs_path, out_dir = argv[3], argv[4], argv[5]
    if "://" not in init:
        init = f"file://{init}"
    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    if group == "cli":
        result = cli_rank(rank, world, init, inputs)
    elif group == "nccl":    # never joins: NCCL on one device must raise
        try:
            meshlib.init_distributed("nccl", init, world, rank,
                                     "cuda:0")
            result = {"raised": None}
        except ValueError as e:
            result = {"raised": str(e)}
    else:
        meshlib.init_distributed("gloo", init, world, rank,
                                 inputs.get("device", "cpu"))
        result = GROUPS[group](rank, world, inputs)
        torch.distributed.destroy_process_group()
    with open(os.path.join(out_dir, f"{group}_{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


if __name__ == "__main__":
    main(sys.argv[1:])
