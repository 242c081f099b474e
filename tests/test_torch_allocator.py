"""The port's chunk allocator (xvector_tpu_torch.data.allocator) against
the JAX package's: the same corpus, config and seed give identical plans,
chunk for chunk (utterance, offset, length, label, padded length), under
every strategy, length strategy, snapping and reference-semantics switch.
That identity carries to the port the JAX package's proof against the
executed reference (tests/test_reference_dataplane.py).  The property
tests of tests/test_data_plane.py are mirrored on the port's copy."""

import collections

import numpy as np
import pytest

from xvector_tpu.data import allocator as J
from xvector_tpu_torch.data import allocator as P


def _toy_corpus(num_spk=6, utts_per_spk=4, min_len=500, seed=0, aug=False):
    rng = np.random.RandomState(seed)
    utt2len, utt2label = {}, {}
    for s in range(num_spk):
        for u in range(utts_per_spk):
            name = f"s{s}_u{u}"
            utt2len[name] = int(min_len + rng.randint(0, 500))
            utt2label[name] = s
            if aug:   # augmented copies share the recording's base
                for kind in ("noise", "reverb"):
                    utt2len[f"{name}-{kind}"] = utt2len[name]
                    utt2label[f"{name}-{kind}"] = s
    return utt2len, utt2label


def _cfg(mod, **kw):
    base = dict(min_frames=100, max_frames=200, minibatch_size=8,
                num_repeats=4, frames_per_iter=6_000)
    base.update(kw)
    return mod.AllocatorConfig(**base)


def _flat(plans):
    """Every field of every chunk, minibatch and archive, as plain data."""
    return [(p.index, [(mb.length, mb.padded_length,
                        [(c.utt, c.offset, c.length, c.label)
                         for c in mb.chunks])
                       for mb in p.minibatches])
            for p in plans]


@pytest.mark.parametrize("seed", [1, 7, 2468])
@pytest.mark.parametrize("snap", [True, False])
@pytest.mark.parametrize("length_strategy", ["random", "deterministic"])
@pytest.mark.parametrize("strategy", ["per_archive", "kaldi_original",
                                      "whole", "reference"])
def test_plans_identical_to_jax(strategy, length_strategy, snap, seed):
    utt2len, utt2label = _toy_corpus(aug=strategy != "kaldi_original",
                                     seed=seed)
    if strategy == "reference":   # the executed reference's exact mirror
        kw = dict(strategy="per_archive", reference_semantics=True)
    else:
        kw = dict(strategy=strategy)
    kw.update(length_strategy=length_strategy, snap_to_bucket=snap,
              seed=seed)
    got = list(P.allocate_archives(utt2len, utt2label, _cfg(P, **kw),
                                   num_archives=3))
    want = list(J.allocate_archives(utt2len, utt2label, _cfg(J, **kw),
                                    num_archives=3))
    assert _flat(got) == _flat(want)
    assert sum(len(p.minibatches) for p in got) > 0


@pytest.mark.parametrize("reference", [False, True])
def test_derived_archive_count_identical_to_jax(reference):
    """num_archives=None derives the count as get_egs.sh:120 does."""
    utt2len, utt2label = _toy_corpus(num_spk=4, utts_per_spk=3)
    kw = dict(frames_per_iter=20_000, reference_semantics=reference,
              seed=5)
    got = list(P.allocate_archives(utt2len, utt2label, _cfg(P, **kw)))
    want = list(J.allocate_archives(utt2len, utt2label, _cfg(J, **kw)))
    assert len(got) == len(want) > 1
    assert _flat(got) == _flat(want)


def test_reference_offset_groups_identical_to_jax():
    utt2len = {"a": 900, "a-b": 900, "a-b-c": 900, "x-1": 900, "y": 900}
    got = P._reference_offset_groups(utt2len)
    want = J._reference_offset_groups(utt2len)
    # same aliasing: keys bound to one shared list in each
    alias = lambda g: sorted(sorted(k for k in g if g[k] is v)
                             for v in {id(v): v for v in g.values()}.values())
    assert alias(got) == alias(want)


@pytest.mark.parametrize("utt", ["sre_1234-noise", "sre_1234-reverb",
                                 "sre_1234-babble", "sre_1234-music",
                                 "sre_1234-rev2", "sre_1234", "sre-A-5"])
def test_base_utt_matches_jax(utt):
    assert P.base_utt(utt) == J.base_utt(utt)


@pytest.mark.parametrize("args", [(0, 5, 200, 400), (4, 5, 200, 400),
                                  (2, 5, 200, 400), (3, 1, 200, 400),
                                  (1, 9, 300, 300), (5, 7, 123, 457)])
def test_deterministic_chunk_length_matches_jax(args):
    assert (P.deterministic_chunk_length(*args)
            == J.deterministic_chunk_length(*args))


@pytest.mark.parametrize("bucket", [1, 32])
def test_ranges_round_trip(bucket):
    utt2len, utt2label = _toy_corpus(num_spk=3, utts_per_spk=3)
    cfg = _cfg(P, length_bucket=bucket)
    (plan,) = P.allocate_archives(utt2len, utt2label, cfg, num_archives=1)
    lines = plan.to_ranges_lines()
    (jplan,) = J.allocate_archives(utt2len, utt2label,
                                   _cfg(J, length_bucket=bucket),
                                   num_archives=1)
    assert lines == jplan.to_ranges_lines()
    back = P.ArchivePlan.from_ranges_lines(0, lines, length_bucket=bucket)
    assert back.minibatches == plan.minibatches
    jback = J.ArchivePlan.from_ranges_lines(0, lines, length_bucket=bucket)
    assert _flat([back]) == _flat([jback])


def test_chunk_invariants():
    utt2len, utt2label = _toy_corpus()
    cfg = _cfg(P, frames_per_iter=50_000, seed=1)
    plans = list(P.allocate_archives(utt2len, utt2label, cfg,
                                     num_archives=2))
    assert len(plans) == 2
    for plan in plans:
        assert plan.frames > 0
        for mb in plan.minibatches:
            assert len(mb.chunks) == cfg.minibatch_size
            assert cfg.min_frames <= mb.length <= cfg.max_frames
            assert mb.padded_length % cfg.length_bucket == 0
            assert mb.padded_length >= mb.length
            for c in mb.chunks:
                assert c.length == mb.length
                assert 0 <= c.offset
                assert c.offset + c.length <= utt2len[c.utt]
                assert c.label == utt2label[c.utt]


def test_speaker_balance():
    utt2len, utt2label = _toy_corpus(num_spk=10)
    (plan,) = P.allocate_archives(utt2len, utt2label,
                                  _cfg(P, frames_per_iter=50_000, seed=1),
                                  num_archives=1)
    counts = collections.Counter(c.label for mb in plan.minibatches
                                 for c in mb.chunks)
    expect = sum(counts.values()) / 10
    for spk in range(10):
        assert 0.5 * expect <= counts[spk] <= 2.0 * expect


def test_overlap_control():
    utt2len = {"s0_u0": 100_000}
    utt2label = {"s0_u0": 0}
    cfg = P.AllocatorConfig(min_frames=100, max_frames=100,
                            minibatch_size=4, num_repeats=8,
                            frames_per_iter=4_000, seed=3,
                            accepted_overlap=0.0, length_bucket=1)
    (plan,) = P.allocate_archives(utt2len, utt2label, cfg, num_archives=1)
    spans = [(c.offset, c.offset + c.length) for mb in plan.minibatches
             for c in mb.chunks]
    overlapping = sum(1 for i, (s1, e1) in enumerate(spans)
                      for s2, e2 in spans[i + 1:]
                      if min(e1, e2) - max(s1, s2) > 0)
    assert overlapping <= len(spans) // 10


def test_snap_fills_padded_shapes_exactly():
    utt2len, utt2label = _toy_corpus()
    cfg = _cfg(P, max_frames=400, frames_per_iter=50_000, seed=5)
    lengths = set()
    for p in P.allocate_archives(utt2len, utt2label, cfg, num_archives=2):
        for mb in p.minibatches:
            assert mb.length == mb.padded_length
            assert mb.length % 32 == 0
            assert cfg.min_frames <= mb.length <= cfg.max_frames
            lengths.add(mb.length)
    assert len(lengths) > 1


def test_kaldi_original_one_length_and_repeat_cap():
    utt2len, utt2label = _toy_corpus()
    cfg = _cfg(P, frames_per_iter=4_000, seed=3, strategy="kaldi_original")
    for plan in P.allocate_archives(utt2len, utt2label, cfg,
                                    num_archives=3):
        assert len({mb.length for mb in plan.minibatches}) == 1
        draws = collections.Counter(c.label for mb in plan.minibatches
                                    for c in mb.chunks)
        assert max(draws.values()) <= cfg.num_repeats


def test_whole_strategy_weighting_and_replacement():
    utt2len = {f"rich_u{u}": 600 for u in range(25)}
    utt2label = {u: 0 for u in utt2len}
    utt2len["poor_u0"], utt2label["poor_u0"] = 600, 1
    cfg = P.AllocatorConfig(min_frames=100, max_frames=100, minibatch_size=4,
                            num_repeats=6, frames_per_iter=6_000, seed=5,
                            strategy="whole")
    (plan,) = P.allocate_archives(utt2len, utt2label, cfg, num_archives=1)
    draws = collections.Counter(c.label for mb in plan.minibatches
                                for c in mb.chunks)
    assert draws[0] > draws[1]
    rich = [c.utt for mb in plan.minibatches for c in mb.chunks
            if c.label == 0][:25]
    assert len(set(rich)) == len(rich)


@pytest.mark.parametrize("case", ["unknown_strategy", "no_long_utt",
                                  "reference_other_strategy",
                                  "reference_all_short_speaker"])
def test_value_errors_match_jax(case):
    utt2len, utt2label = _toy_corpus()
    kw = {"unknown_strategy": dict(strategy="bogus"),
          "no_long_utt": dict(min_frames=5_000, max_frames=5_000),
          "reference_other_strategy": dict(strategy="whole",
                                           reference_semantics=True),
          "reference_all_short_speaker": dict(
              min_frames=200, max_frames=400, minibatch_size=2,
              num_repeats=8, frames_per_iter=4_000, seed=0,
              reference_semantics=True)}[case]
    if case == "reference_all_short_speaker":
        utt2len = {"a0": 500, "a1": 480, "b0": 150, "b1": 160}
        utt2label = {"a0": 0, "a1": 0, "b0": 1, "b1": 1}
    msgs = []
    for mod in (P, J):
        with pytest.raises(ValueError) as err:
            list(mod.allocate_archives(utt2len, utt2label,
                                       mod.AllocatorConfig(**kw),
                                       num_archives=2))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
