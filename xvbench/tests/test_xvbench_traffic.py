"""The traffic generators: deterministic by seed, stratified so that the
audio of a run's inputs does not depend on the seed, and archives that read
back through the program's reader."""

import numpy as np
import torch

from xvbench import generate, harness
from xvbench.tests.tiny import EXTRACT, TINY, TRAIN

from xvector_tpu_torch.data import archives as A


def _shipped(name):
    return harness.load_json(harness.HERE, "traffic", name + ".json")


def test_archive_lengths_are_a_permutation_of_the_strata():
    t = _shipped("train_egs")
    a, b = (generate.archive_lengths(t, s) for s in (1, 2**31 + 3))
    assert sorted(a) == sorted(b) == t["chunk_lengths"]
    assert a != b
    # 64 rows x the mean stratum x 10 ms: 191.68 audio-s per minibatch
    assert 64 * np.mean(t["chunk_lengths"]) / 100 == 191.68


def test_two_seeds_same_audio_other_contents():
    seeds = (7, 2**31 + 9)
    totals, first = [], []
    for s in seeds:
        lengths = generate.archive_lengths(TRAIN, s)
        totals.append(sum(lengths) * TRAIN["rows"]
                      * TRAIN["minibatches_per_archive"])
        x, y = generate.archive_minibatches(TRAIN, TINY, s, 0, lengths[0],
                                            "cpu")
        first.append(x)
        assert x.dtype == torch.float16 and int(y.max()) < TINY["num_targets"]
    assert totals[0] == totals[1]
    n = min(f.shape[2] for f in first)
    assert not torch.equal(first[0][..., :n, :], first[1][..., :n, :])
    again, _ = generate.archive_minibatches(
        TRAIN, TINY, seeds[0], 0, generate.archive_lengths(TRAIN, seeds[0])[0],
        "cpu")
    assert torch.equal(again, first[0])


def test_archives_read_back_through_the_program(tmp_path):
    lengths = generate.archive_lengths(TRAIN, 3)
    x, y = generate.archive_minibatches(TRAIN, TINY, 3, 1, lengths[1], "cpu")
    path = str(tmp_path / "egs.1.xta")
    xs, ys = x.numpy(), y.to(torch.int32).numpy()
    A.write_archive(path, [(xs[m], ys[m], lengths[1])
                           for m in range(xs.shape[0])])
    with A.ArchiveReader(path) as r:
        got = list(A.PrefetchLoader(r))
    assert len(got) == TRAIN["minibatches_per_archive"]
    for m, (f, l, t) in enumerate(got):
        assert t == lengths[1] and f.shape == (TRAIN["rows"], t, 23)
        assert np.array_equal(f, xs[m]) and np.array_equal(l, ys[m])


def test_pool_same_frames_and_voiced_counts_other_contents():
    t = _shipped("extract_feats")
    lengths = generate.pool_lengths(t)
    assert lengths[0] >= t["min_frames"] and lengths[-1] <= t["max_frames"]
    assert len(lengths) == t["utterances"] == 512
    pools = [generate.extraction_pool(EXTRACT, TINY, s, "cpu")
             for s in (5, 2**31 + 5)]
    for key in (lambda u: len(u[0]), lambda u: int(u[1].sum())):
        assert sorted(map(key, pools[0])) == sorted(map(key, pools[1]))
    assert [len(u[0]) for u in pools[0]] != [len(u[0]) for u in pools[1]]
    again = generate.extraction_pool(EXTRACT, TINY, 5, "cpu")
    assert all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
               for a, b in zip(again, pools[0]))


def test_vad_runs_are_in_range_and_mostly_voiced():
    t = _shipped("extract_feats")
    vad = generate.vad_decisions(t, 3, 20_000)
    edges = np.flatnonzero(np.diff(vad)) + 1
    runs = np.diff(np.concatenate([[0], edges, [len(vad)]]))
    voiced = runs[0::2][:-1]
    silent = runs[1::2][:-1]
    assert voiced.min() >= 50 and voiced.max() <= 300
    assert silent.min() >= 20 and silent.max() <= 100
    assert 0.6 < vad.mean() < 0.85


def test_weights_are_deterministic_and_seeded():
    a, sa = generate.weights(TINY, 4, "cpu")
    b, _ = generate.weights(TINY, 4, "cpu")
    c, _ = generate.weights(TINY, 5, "cpu")
    assert torch.equal(a["frame"][1]["w"], b["frame"][1]["w"])
    assert not torch.equal(a["frame"][1]["w"], c["frame"][1]["w"])
    assert a["frame"][0]["w"].shape == (5, 23, 32)
    assert a["output"]["w"].shape == (64, TINY["num_targets"])
    assert float(sa["frame"][0]["var"].min()) > 0


def test_large_seeds_derive_distinct_streams():
    big = [2**31 + 1, 2**31 + 2, 2**40]
    assert len({generate.derive(s, "weights") for s in big}) == 3
    assert all(0 <= generate.derive(s, "x") < 2**63 for s in big)
