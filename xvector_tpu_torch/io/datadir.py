"""Typed Kaldi "data dir" manifests and their algebra.

One module replacing the Kaldi ``utils/*`` data-dir scripts the reference
leans on throughout (``combine_data.sh``, ``fix_data_dir.sh``,
``filter_scp.pl``, ``subset_data_dir.sh``, ``split_data.sh``,
``spk2utt_to_utt2spk.pl``, ``validate_data_dir.sh``, ``copy_data_dir.sh``;
see reference ``run.sh:60-66,105,166-185`` and ``get_egs.sh:100-112``).

A :class:`DataDir` is an in-memory manifest — ``utt → wav/feats/vad/spk`` —
with functional operations (filter/subset/combine/split) that all re-derive
``spk2utt`` from ``utt2spk`` so the two can never disagree.

Own copy of ``xvector_tpu/io/datadir.py`` (pure Python).
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass, field, replace
from typing import Dict, Iterable, List

__all__ = ["DataDir", "load_data_dir"]


def _read_kv(path: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split(None, 1)
            if len(parts) == 2:
                out[parts[0]] = parts[1]
    return out


def _write_kv(path: str, mapping: Dict[str, str]):
    with open(path, "w") as f:
        for k in sorted(mapping):
            f.write(f"{k} {mapping[k]}\n")


@dataclass(frozen=True)
class DataDir:
    """Immutable utterance manifest. All maps are keyed by utterance id,
    except ``spk2utt`` which is derived."""

    utt2spk: Dict[str, str]
    wav: Dict[str, str] = field(default_factory=dict)        # utt → wav path/cmd
    feats: Dict[str, str] = field(default_factory=dict)      # utt → ark offset
    vad: Dict[str, str] = field(default_factory=dict)        # utt → ark offset
    utt2num_frames: Dict[str, int] = field(default_factory=dict)
    spk2gender: Dict[str, str] = field(default_factory=dict)  # spk → m|f

    # ---- derived -----------------------------------------------------------
    @property
    def utts(self) -> List[str]:
        return sorted(self.utt2spk)

    @property
    def spk2utt(self) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {}
        for utt in sorted(self.utt2spk):
            out.setdefault(self.utt2spk[utt], []).append(utt)
        return out

    @property
    def speakers(self) -> List[str]:
        return sorted(set(self.utt2spk.values()))

    def __len__(self) -> int:
        return len(self.utt2spk)

    # ---- algebra (replaces utils/{filter_scp,subset,combine,split}) --------
    def filter(self, keep: Iterable[str]) -> "DataDir":
        keep = set(keep)

        def f(d):
            return {k: v for k, v in d.items() if k in keep}

        u2s = f(self.utt2spk)
        spks = set(u2s.values())
        return DataDir(u2s, f(self.wav), f(self.feats),
                       f(self.vad), f(self.utt2num_frames),
                       {s: g for s, g in self.spk2gender.items()
                        if s in spks})

    def exclude(self, drop: Iterable[str]) -> "DataDir":
        drop = set(drop)
        return self.filter(u for u in self.utt2spk if u not in drop)

    def subset_utts(self, n: int, seed: int = 0) -> "DataDir":
        rng = random.Random(seed)
        utts = self.utts
        rng.shuffle(utts)
        return self.filter(utts[:n])

    def subset_speakers(self, min_utts: int) -> "DataDir":
        """Keep only speakers with ≥ min_utts utterances (reference
        ``run.sh:183-185`` keeps speakers with ≥ 8 post-silence utts)."""
        keep = [u for spk, us in self.spk2utt.items() if len(us) >= min_utts
                for u in us]
        return self.filter(keep)

    def filter_min_frames(self, min_frames: int) -> "DataDir":
        """Drop utterances shorter than min_frames (reference
        ``run.sh:177-181`` drops < 5 s ⇒ < 500 frames)."""
        keep = [u for u, n in self.utt2num_frames.items() if n >= min_frames]
        return self.filter(keep)

    def combine(self, *others: "DataDir") -> "DataDir":
        out = self
        for o in others:
            out = DataDir({**out.utt2spk, **o.utt2spk},
                          {**out.wav, **o.wav},
                          {**out.feats, **o.feats},
                          {**out.vad, **o.vad},
                          {**out.utt2num_frames, **o.utt2num_frames},
                          {**out.spk2gender, **o.spk2gender})
        return out

    def split(self, n: int) -> List["DataDir"]:
        """Round-robin split into n shards (per-utt, like
        ``split_data.sh --per-utt``)."""
        utts = self.utts
        return [self.filter(utts[i::n]) for i in range(n)]

    def map_speakers(self, fn) -> "DataDir":
        return replace(self, utt2spk={u: fn(s)
                                      for u, s in self.utt2spk.items()},
                       spk2gender={fn(s): g
                                   for s, g in self.spk2gender.items()})

    # ---- label mapping (get_egs.sh stage 0: spk2int / utt2int) -------------
    def spk2int(self) -> Dict[str, int]:
        return {s: i for i, s in enumerate(self.speakers)}

    def utt2int(self) -> Dict[str, int]:
        s2i = self.spk2int()
        return {u: s2i[s] for u, s in self.utt2spk.items()}

    # ---- validation (validate_data_dir.sh / fix_data_dir.sh) ---------------
    def validate(self) -> "DataDir":
        """Drop utterances missing from any populated map; never raises for
        recoverable issues (fix_data_dir semantics)."""
        keys = set(self.utt2spk)
        for m in (self.wav, self.feats, self.vad, self.utt2num_frames):
            if m:
                keys &= set(m)
        return self.filter(keys)

    # ---- persistence -------------------------------------------------------
    def save(self, path: str):
        os.makedirs(path, exist_ok=True)
        _write_kv(os.path.join(path, "utt2spk"), self.utt2spk)
        with open(os.path.join(path, "spk2utt"), "w") as f:
            for spk, us in sorted(self.spk2utt.items()):
                f.write(f"{spk} {' '.join(us)}\n")
        if self.wav:
            _write_kv(os.path.join(path, "wav.scp"), self.wav)
        if self.feats:
            _write_kv(os.path.join(path, "feats.scp"), self.feats)
        if self.vad:
            _write_kv(os.path.join(path, "vad.scp"), self.vad)
        if self.utt2num_frames:
            _write_kv(os.path.join(path, "utt2num_frames"),
                      {k: str(v) for k, v in self.utt2num_frames.items()})
        if self.spk2gender:
            _write_kv(os.path.join(path, "spk2gender"), self.spk2gender)


def load_data_dir(path: str) -> DataDir:
    """Load a Kaldi-format data dir from disk."""
    def opt(name):
        p = os.path.join(path, name)
        return _read_kv(p) if os.path.exists(p) else {}

    utt2spk = _read_kv(os.path.join(path, "utt2spk"))
    n_frames = {k: int(v) for k, v in opt("utt2num_frames").items()}
    return DataDir(utt2spk, opt("wav.scp"), opt("feats.scp"), opt("vad.scp"),
                   n_frames, opt("spk2gender"))
