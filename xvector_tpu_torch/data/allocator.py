"""Chunk allocation: plan which (utterance, offset, length, label) chunks go
into which minibatch of which training archive.

Own copy of ``xvector_tpu/data/allocator.py`` (pure Python on
``random.Random``): the same seed gives the same plans, chunk for chunk.

Re-implements the active strategy of the reference's egs allocator
(``create_egs.py:477-570`` ``our_splitting_per_archive``) with the same
statistical guarantees:

* one random chunk length per minibatch, uniform in
  [min_frames, max_frames] (``create_egs.py:203-217`` deterministic per-RNG);
* speaker balance: every speaker appears ``num_repeats`` times in a shuffled
  draw pool per archive; utterances are sampled per speaker **without
  replacement** until the speaker's list is exhausted, then refilled
  (``get_random_utt_without_replacement``);
* overlap control: a chunk's offset is resampled (bounded attempts) until its
  overlap with previously-used chunks of the same *base* utterance — the
  utterance id with its augmentation suffix stripped, so ``utt-noise`` and
  ``utt-reverb`` count as the same recording — is ≤ ``accepted_overlap``
  of the chunk length (``create_egs.py:247-282``, ``--accepted-overlap=0.2``);
* archives are filled until ``frames_per_iter`` frames are planned
  (``create_egs.py:503``).

Change vs the reference: chunk lengths are quantised up to a multiple of
``length_bucket`` and chunks carry their true length, so each archive
yields a small closed set of padded minibatch shapes (equal shapes stack
into the trainer's blocks), with masked pooling/BN handling the pad frames.
Setting ``length_bucket=1`` recovers exact reference behaviour.

The default ``per_archive`` path deliberately DEVIATES from the reference
in five bounded ways (each a shape- or robustness-motivated adaptation; set
``reference_semantics=True`` for a bit-exact mirror of the reference's
RNG call sequence, proven against the executed ``create_egs.py`` in
``tests/test_reference_dataplane.py``):

* stop rule: the reference fills until ``frames_per_iter`` or the draw
  pool runs short (``create_egs.py:503-506``); the default path caps the
  target at a per-archive share of the corpus and REFILLS the pool, so
  tiny test corpora still produce balanced archives;
* overlap bookkeeping scope: the reference clears it per archive
  (``create_egs.py:499-500``); the default tracker is global across
  archives (strictly less repeated data);
* base-utterance grouping: the reference strips after the last ``-``
  only when the stripped prefix is itself a key (``create_egs.py:269-282``);
  the default uses an explicit augmentation-suffix regex;
* offset retry budget: the reference allows ``utt_len/length + 1``
  resamples (``create_egs.py:260``); the default uses a fixed bound;
* overlap acceptance: the reference compares the OFFSET DISTANCE
  ``|pre_off − off|`` against ``(1 − accepted_overlap)·len`` where len is
  the earlier-starting chunk's length (``create_egs.py:247-253``) — not
  the actual interval intersection; the default uses true
  intersection/length, which is equivalent for equal lengths but stricter
  symmetric behaviour for mixed lengths.

Besides the active per-archive strategy the reference carries two dormant
allocators (selected at ``create_egs.py:587``; both write the older
6-column nnet3 ranges format and leave minibatch assembly to the
consumer).  Both are implemented here as selectable ``strategy`` values,
adapted to this framework's minibatch-plan contract:

* ``kaldi_original`` (``create_egs.py:285-374``): ONE chunk length per
  archive; the draw pool is ``num_repeats`` copies of every speaker,
  shuffled, consumed without refill; utterances are drawn uniformly WITH
  replacement; offsets are uniform with no overlap control.
* ``whole`` (``our_splitting``, ``create_egs.py:377-474``): one length per
  archive; per-speaker pool weight
  ``num_repeats · (max_frames/length) · max(log₅|utts|, 1)`` so longer
  archives and utterance-rich speakers draw proportionally more;
  utterances without replacement; overlap-minimised offsets whose
  bookkeeping resets per archive.
"""

from __future__ import annotations

import math
import random
import re
from dataclasses import dataclass
from typing import Dict, Iterator, List, Tuple

__all__ = ["ChunkSpec", "MinibatchPlan", "ArchivePlan", "AllocatorConfig",
           "allocate_archives", "base_utt"]

_AUG_SUFFIX = re.compile(r"-(noise|music|babble|reverb|rev\d*)$")


def base_utt(utt: str) -> str:
    """Strip one augmentation suffix so augmented copies share overlap
    bookkeeping with their source recording (create_egs.py:285-307 strips
    the trailing ``-suffix``)."""
    return _AUG_SUFFIX.sub("", utt)


@dataclass(frozen=True)
class ChunkSpec:
    utt: str
    offset: int      # first frame
    length: int      # true (unpadded) frame count
    label: int       # speaker int id


@dataclass(frozen=True)
class MinibatchPlan:
    chunks: Tuple[ChunkSpec, ...]
    length: int          # true chunk length shared by the minibatch
    padded_length: int   # bucketed length the tensor is padded to

    @property
    def frames(self) -> int:
        return len(self.chunks) * self.length


@dataclass(frozen=True)
class ArchivePlan:
    index: int
    minibatches: Tuple[MinibatchPlan, ...]

    @property
    def frames(self) -> int:
        return sum(mb.frames for mb in self.minibatches)

    def to_ranges_lines(self) -> List[str]:
        """Reference-compatible ranges rows ``<utt> <mb> <rel-idx> <offset>
        <len> <label>`` (create_egs.py:533 format) for interop/debugging."""
        lines = []
        for mb_i, mb in enumerate(self.minibatches):
            for rel, c in enumerate(mb.chunks):
                lines.append(
                    f"{c.utt} {mb_i} {rel} {c.offset} {c.length} {c.label}")
        return lines

    @classmethod
    def from_ranges_lines(cls, index: int, lines, length_bucket: int = 32
                          ) -> "ArchivePlan":
        """Inverse of :meth:`to_ranges_lines`: rebuild a plan from
        reference-format ranges rows (so plans persist as the same text
        artifact the reference writes, ``create_egs.py:533``)."""
        per_mb: dict = {}
        for line in lines:
            parts = line.split()
            if not parts:
                continue
            utt, mb_i, rel, off, ln, lab = (parts[0], int(parts[1]),
                                            int(parts[2]), int(parts[3]),
                                            int(parts[4]), int(parts[5]))
            per_mb.setdefault(mb_i, []).append(
                (rel, ChunkSpec(utt, off, ln, lab)))
        mbs = []
        for mb_i in sorted(per_mb):
            chunks = tuple(c for _, c in sorted(per_mb[mb_i]))
            length = chunks[0].length
            mbs.append(MinibatchPlan(chunks, length,
                                     _round_up(length, length_bucket)))
        return cls(index, tuple(mbs))


@dataclass(frozen=True)
class AllocatorConfig:
    min_frames: int = 200           # run_xvector.sh:58
    max_frames: int = 400           # run_xvector.sh:59
    minibatch_size: int = 64        # run_xvector.sh:47
    num_repeats: int = 35           # run_xvector.sh:62
    frames_per_iter: int = 10 ** 9  # run_xvector.sh:56
    accepted_overlap: float = 0.2   # get_egs.sh --accepted-overlap default
    max_offset_attempts: int = 10
    length_bucket: int = 32         # shape-bucketing granularity
    # snap each sampled chunk length onto the bucket grid (largest
    # multiple of length_bucket <= draw, floored at the smallest multiple
    # >= min_frames).  Every minibatch then fills its padded shape
    # EXACTLY: no wasted pad frames (~5% of compute at bucket 32) and the
    # trainer's mask-free dense fast path fires on every block.  The draw
    # RNG sequence is unchanged, so False recovers the reference's exact length distribution
    # (create_egs.py:503-513 per-minibatch uniform draw) at the cost of
    # masked padding.
    snap_to_bucket: bool = True
    seed: int = 2468                # run_xvector.sh:85
    # chunk-length strategy: "random" (active reference path, per-minibatch
    # uniform draw) or "deterministic" (create_egs.py:223-231: geometric
    # interpolation min→max across archives, one length per archive)
    length_strategy: str = "random"
    # allocation strategy: "per_archive" (the reference's active
    # our_splitting_per_archive), "kaldi_original", or "whole"
    # (our_splitting) — see module docstring
    strategy: str = "per_archive"
    # bit-exact mirror of the reference allocator's RNG call sequence
    # (per_archive strategy only; see module docstring for the five
    # behaviours this switches).  Plans produced with the same seed are
    # identical to the ranges files the reference's create_egs.py writes.
    reference_semantics: bool = False


class _SpeakerSampler:
    """Sample utterances per speaker without replacement, refilling when a
    speaker's pool empties."""

    def __init__(self, spk2utts: Dict[int, List[str]], rng: random.Random):
        self._all = {s: list(us) for s, us in spk2utts.items()}
        self._pool: Dict[int, List[str]] = {}
        self._rng = rng

    def draw(self, spk: int, min_len: int,
             utt_len: Dict[str, int]) -> str | None:
        pool = self._pool.get(spk)
        if not pool:
            pool = list(self._all[spk])
            self._rng.shuffle(pool)
            self._pool[spk] = pool
        # scan from the end (pop is O(1)) for an utterance long enough
        for i in range(len(pool) - 1, -1, -1):
            if utt_len[pool[i]] >= min_len:
                return pool.pop(i)
        # none long enough in the remaining pool; try the full list once
        candidates = [u for u in self._all[spk] if utt_len[u] >= min_len]
        return self._rng.choice(candidates) if candidates else None


class _OverlapTracker:
    """Per-base-recording used-interval bookkeeping (create_egs.py:247-266)."""

    def __init__(self):
        self._used: Dict[str, List[Tuple[int, int]]] = {}

    def overlap_frac(self, base: str, start: int, length: int) -> float:
        worst = 0
        for s, e in self._used.get(base, ()):
            inter = min(e, start + length) - max(s, start)
            if inter > worst:
                worst = inter
        return worst / length

    def add(self, base: str, start: int, length: int):
        self._used.setdefault(base, []).append((start, start + length))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _snap_length(length: int, cfg: "AllocatorConfig") -> int:
    """Largest bucket multiple <= length, floored at the smallest bucket
    multiple >= min_frames; identity when snapping is off or the bucket
    grid has no point inside [min_frames, max_frames]."""
    if not cfg.snap_to_bucket or cfg.length_bucket <= 1:
        return length
    lo = _round_up(cfg.min_frames, cfg.length_bucket)
    if lo > cfg.max_frames:
        return length
    snapped = (length // cfg.length_bucket) * cfg.length_bucket
    return max(lo, min(snapped, cfg.max_frames))


def deterministic_chunk_length(archive_id: int, num_archives: int,
                               min_frames: int, max_frames: int) -> int:
    """Geometric min→max interpolation across archives
    (create_egs.py:223-231)."""
    if max_frames == min_frames or num_archives == 1:
        return max_frames
    return int((max_frames / min_frames)
               ** (archive_id / (num_archives - 1)) * min_frames + 0.5)


def _archive_length(cfg: AllocatorConfig, rng: random.Random,
                    arch_i: int, num_archives: int) -> int:
    """One chunk length for a whole archive (kaldi_original/whole
    strategies, create_egs.py:295-302 / :394-401)."""
    if cfg.length_strategy == "deterministic":
        return _snap_length(
            deterministic_chunk_length(arch_i, num_archives,
                                       cfg.min_frames, cfg.max_frames), cfg)
    return _snap_length(rng.randint(cfg.min_frames, cfg.max_frames), cfg)


def _pack_minibatches(chunks: List[ChunkSpec], length: int,
                      cfg: AllocatorConfig) -> Tuple[MinibatchPlan, ...]:
    """Group a flat eg list (single shared length) into minibatch plans —
    the adaptation step for the reference's two dormant strategies, whose
    6-column ranges leave batching to the nnet3 consumer."""
    padded = _round_up(length, cfg.length_bucket)
    mbs = []
    for i in range(0, len(chunks) - cfg.minibatch_size + 1,
                   cfg.minibatch_size):
        mbs.append(MinibatchPlan(tuple(chunks[i:i + cfg.minibatch_size]),
                                 length, padded))
    return tuple(mbs)


def _allocate_whole_archive(utt2len: Dict[str, int], spk2utts,
                            cfg: AllocatorConfig, rng: random.Random,
                            num_archives: int) -> Iterator[ArchivePlan]:
    """The two dormant whole-archive strategies (see module docstring)."""
    kaldi = cfg.strategy == "kaldi_original"
    sampler = _SpeakerSampler(spk2utts, rng)       # without-replacement
    # log₅ utterance-count weight, constant across archives
    # (create_egs.py:383)
    spk_weight = {s: max(math.log(len(us)) / math.log(5.0), 1.0)
                  for s, us in spk2utts.items()}
    for arch_i in range(num_archives):
        length = _archive_length(cfg, rng, arch_i, num_archives)
        n_egs = int(cfg.frames_per_iter / length) + 1
        if kaldi:
            draw_pool = [s for s in spk2utts for _ in range(cfg.num_repeats)]
        else:
            weight = cfg.max_frames / length       # create_egs.py:405
            draw_pool = [s for s in spk2utts
                         for _ in range(int(cfg.num_repeats * weight
                                            * spk_weight[s]))]
        rng.shuffle(draw_pool)
        overlaps = _OverlapTracker()               # reset per archive
        chunks: List[ChunkSpec] = []
        while len(chunks) < n_egs and draw_pool:
            spk = draw_pool.pop()
            if kaldi:
                pool = [u for u in spk2utts[spk] if utt2len[u] >= length]
                utt = rng.choice(pool) if pool else None
            else:
                utt = sampler.draw(spk, length, utt2len)
            if utt is None:
                continue
            max_off = utt2len[utt] - length
            off = rng.randint(0, max_off) if max_off > 0 else 0
            if not kaldi:
                b = base_utt(utt)
                for _ in range(cfg.max_offset_attempts):
                    if overlaps.overlap_frac(b, off, length) \
                            <= cfg.accepted_overlap:
                        break
                    off = rng.randint(0, max_off) if max_off > 0 else 0
                overlaps.add(b, off, length)
            chunks.append(ChunkSpec(utt, off, length, spk))
        yield ArchivePlan(arch_i, _pack_minibatches(chunks, length, cfg))


def _reference_offset_groups(utt2len: Dict[str, int]) -> Dict[str, list]:
    """utt → SHARED used-interval list, grouped by the reference's
    conditional-rfind rule (create_egs.py:269-282): strip after the last
    ``-`` only when the stripped prefix is itself a utt2len key; keys
    without a usable prefix own their list.  Aliasing (several keys bound
    to one list object) reproduces the reference exactly, including its
    iteration-order quirk for multi-level suffix chains (``a-b-c`` aliases
    ``a-b``'s CURRENT list even if ``a-b`` is later re-bound to ``a``'s)."""
    groups: Dict[str, list] = {}
    for utt in utt2len.keys():
        cut = utt.rfind("-")
        head = utt[:cut] if cut > 0 and utt[:cut] in utt2len else utt
        if head not in groups:
            groups[head] = []
        groups[utt] = groups[head]
    return groups


def _reference_offset_ok(off: int, used, length: int,
                         accepted_overlap: float) -> bool:
    """The reference's acceptance predicate (create_egs.py:247-253):
    offset DISTANCE to each used chunk, normalised by the earlier-starting
    chunk's length, must reach ``1 − accepted_overlap``.  Kept verbatim in
    semantics (not intersection-based) so reference mode is bit-faithful."""
    for pre_off, pre_len in used:
        ruler = length if off < pre_off else pre_len
        if abs(pre_off - off) / ruler < (1.0 - accepted_overlap):
            return False
    return True


def _allocate_reference_exact(utt2len: Dict[str, int],
                              utt2label: Dict[str, int],
                              cfg: AllocatorConfig, rng: random.Random,
                              num_archives: int) -> Iterator[ArchivePlan]:
    """Bit-exact mirror of the reference's active allocator
    (``our_splitting_per_archive``, create_egs.py:477-545): every RNG call
    (shuffles, index draws, offset draws — including the state-consuming
    ``randint(0, 0)`` on zero-slack offsets) happens in the same order on
    the same Mersenne stream, so a plan from ``seed`` equals the ranges
    files ``create_egs.py --seed=<seed>`` writes, row for row.  Proven by
    executing the reference in ``tests/test_reference_dataplane.py``.

    Behavioural points mirrored here that the default path adapts (see
    module docstring): no min-length pre-filter (short draws are consumed
    from the without-replacement pool and retried, create_egs.py:515-524);
    pool refill one draw early when ≤1 utterance remains
    (create_egs.py:203-210); per-archive overlap reset with
    without-replacement pools persisting ACROSS archives; distance-based
    acceptance with a ``utt_len/length + 1`` retry budget."""
    spk2utt: Dict[int, List[str]] = {}
    for u, s in utt2label.items():
        spk2utt.setdefault(s, []).append(u)
    pools = {s: list(us) for s, us in spk2utt.items()}
    groups = _reference_offset_groups(utt2len)
    # longest utterance per speaker: the reference retries a too-short
    # draw forever (create_egs.py logs and redraws); when a speaker has
    # NO utterance >= the drawn length that loop cannot terminate, so we
    # convert the reference's nontermination into a loud error.  Checked
    # only after a failed draw, so the RNG sequence in every terminating
    # case stays byte-identical to the reference's.
    spk_max = {s: max(utt2len[u] for u in us) for s, us in spk2utt.items()}

    def draw_utt(spk: int) -> str:
        pool = pools[spk]
        n = len(pool)
        if n <= 1:
            pools[spk] = list(spk2utt[spk])   # rebind; pop still from old
        return pool.pop(rng.randint(0, n - 1))

    for arch_i in range(num_archives):
        draw_pool = cfg.num_repeats * list(spk2utt.keys())
        rng.shuffle(draw_pool)
        for used in groups.values():
            del used[:]
        frames_planned = 0
        minibatches: List[MinibatchPlan] = []
        while frames_planned < cfg.frames_per_iter:
            if len(draw_pool) < cfg.minibatch_size:
                break
            if cfg.length_strategy == "deterministic":
                length = deterministic_chunk_length(
                    arch_i, num_archives, cfg.min_frames, cfg.max_frames)
            else:
                length = rng.randint(cfg.min_frames, cfg.max_frames)
            chunks: List[ChunkSpec] = []
            for _ in range(cfg.minibatch_size):
                spk = draw_pool.pop()
                while True:
                    utt = draw_utt(spk)
                    if utt2len[utt] >= length:
                        break
                    if spk_max[spk] < length:
                        raise ValueError(
                            f"speaker {spk}: longest utterance "
                            f"({spk_max[spk]} frames) is shorter than the "
                            f"drawn chunk length {length}; the reference "
                            "allocator would retry forever here — filter "
                            "short speakers or lower max_frames")
                used = groups[utt]
                free = utt2len[utt] - length
                budget = utt2len[utt] / length + 1    # float, as reference
                off = rng.randint(0, free)
                while budget > 0 and not _reference_offset_ok(
                        off, used, length, cfg.accepted_overlap):
                    off = rng.randint(0, free)
                    budget -= 1
                used.append((off, length))
                chunks.append(ChunkSpec(utt, off, length, spk))
                frames_planned += length
            minibatches.append(MinibatchPlan(
                tuple(chunks), length, _round_up(length, cfg.length_bucket)))
        yield ArchivePlan(arch_i, tuple(minibatches))


def allocate_archives(utt2len: Dict[str, int], utt2label: Dict[str, int],
                      cfg: AllocatorConfig,
                      num_archives: int | None = None
                      ) -> Iterator[ArchivePlan]:
    """Yield archive plans.

    utt2len: utterance → usable frame count (post-VAD).
    utt2label: utterance → speaker int.
    num_archives: stop after this many archives; default derives the count
      from total frames as the reference does
      (``get_egs.sh:120``: num_frames·num_repeats/frames_per_iter + 1).
    """
    if cfg.reference_semantics:
        if cfg.strategy != "per_archive":
            raise ValueError("reference_semantics mirrors the reference's "
                             "active per_archive strategy only")
        if num_archives is None:
            total = sum(utt2len.values())
            num_archives = (total * cfg.num_repeats
                            // cfg.frames_per_iter + 1)
        yield from _allocate_reference_exact(
            utt2len, utt2label, cfg, random.Random(cfg.seed), num_archives)
        return

    utts = [u for u in utt2len if utt2len[u] >= cfg.min_frames]
    if not utts:
        raise ValueError("no utterance reaches min_frames")
    spk2utts: Dict[int, List[str]] = {}
    for u in utts:
        spk2utts.setdefault(utt2label[u], []).append(u)

    if num_archives is None:
        total = sum(utt2len[u] for u in utts)
        num_archives = total * cfg.num_repeats // cfg.frames_per_iter + 1

    rng = random.Random(cfg.seed)

    if cfg.strategy in ("kaldi_original", "whole"):
        yield from _allocate_whole_archive(utt2len, spk2utts, cfg, rng,
                                           num_archives)
        return
    if cfg.strategy != "per_archive":
        raise ValueError(f"unknown allocation strategy {cfg.strategy!r}")

    overlaps = _OverlapTracker()

    for arch_i in range(num_archives):
        sampler = _SpeakerSampler(spk2utts, rng)
        draw_pool: List[int] = [s for s in spk2utts
                                for _ in range(cfg.num_repeats)]
        rng.shuffle(draw_pool)
        pool_pos = 0
        minibatches: List[MinibatchPlan] = []
        frames_planned = 0
        target = min(cfg.frames_per_iter,
                     cfg.num_repeats
                     * sum(utt2len[u] for u in utts) // max(num_archives, 1)
                     + cfg.minibatch_size * cfg.max_frames)
        while frames_planned < target:
            if cfg.length_strategy == "deterministic":
                length = deterministic_chunk_length(
                    arch_i, num_archives, cfg.min_frames, cfg.max_frames)
            else:
                length = rng.randint(cfg.min_frames, cfg.max_frames)
            length = _snap_length(length, cfg)
            chunks: List[ChunkSpec] = []
            while len(chunks) < cfg.minibatch_size:
                if pool_pos >= len(draw_pool):
                    rng.shuffle(draw_pool)
                    pool_pos = 0
                spk = draw_pool[pool_pos]
                pool_pos += 1
                utt = sampler.draw(spk, length, utt2len)
                if utt is None:
                    continue
                max_off = utt2len[utt] - length
                off = rng.randint(0, max_off) if max_off > 0 else 0
                b = base_utt(utt)
                for _ in range(cfg.max_offset_attempts):
                    if overlaps.overlap_frac(b, off, length) \
                            <= cfg.accepted_overlap:
                        break
                    off = rng.randint(0, max_off) if max_off > 0 else 0
                overlaps.add(b, off, length)
                chunks.append(ChunkSpec(utt, off, length, spk))
            minibatches.append(MinibatchPlan(
                tuple(chunks), length,
                _round_up(length, cfg.length_bucket)))
            frames_planned += minibatches[-1].frames
        yield ArchivePlan(arch_i, tuple(minibatches))
