"""Augmentation corpus manifests: MUSAN and RIRS_NOISES.

Own copy of the part of ``xvector_tpu/data/corpora.py`` that the recipe's
``--musan-dir`` / ``--rirs-dir`` flags need: :func:`make_musan` (reference
``local/make_musan.py:19-60``) and :func:`make_rirs` (the simulated room
impulse responses ``run.sh:124-142`` reverberates with), with their
helpers.  The LDC/NIST training and evaluation corpus builders come with
``cli/run_sre16.py``.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Tuple

from ..io.datadir import DataDir

__all__ = ["make_musan", "make_rirs", "make_from_table"]

_AUDIO_EXT = (".wav", ".sph", ".flac")


def _walk_audio(root: str) -> List[str]:
    out = []
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.lower().endswith(_AUDIO_EXT):
                out.append(os.path.join(dirpath, f))
    return sorted(out)


def _utt_id(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def make_from_table(rows: Iterable[Tuple[str, str, str]],
                    spk2gender: Optional[Dict[str, str]] = None) -> DataDir:
    """(utt, speaker, wav-path-or-pipe) rows → DataDir."""
    utt2spk, wav = {}, {}
    for utt, spk, path in rows:
        utt2spk[utt] = spk
        wav[utt] = path
    spks = set(utt2spk.values())
    gender = {s: g for s, g in (spk2gender or {}).items() if s in spks}
    return DataDir(utt2spk=utt2spk, wav=wav, spk2gender=gender)


def make_musan(root: str) -> Dict[str, DataDir]:
    """MUSAN → {'music': dd, 'noise': dd, 'speech': dd}; each file is its
    own 'speaker' as in the reference (make_musan.py uses utt==spk for
    noise/music)."""
    out = {}
    for category in ("music", "noise", "speech"):
        cdir = os.path.join(root, category)
        if not os.path.isdir(cdir):
            continue
        rows = []
        for path in _walk_audio(cdir):
            utt = f"{category}-{_utt_id(path)}"
            rows.append((utt, utt, path))
        out[category] = make_from_table(rows)
    return out


def make_rirs(root: str,
              room_types: Tuple[str, ...] = ("smallroom", "mediumroom")
              ) -> Dict[str, List[str]]:
    """RIRS_NOISES/simulated_rirs/<room>/**/*.wav → room type → paths
    (the recipe samples small/medium rooms with p=0.5 each,
    run.sh:126-136)."""
    sim = os.path.join(root, "simulated_rirs")
    base = sim if os.path.isdir(sim) else root
    return {rt: _walk_audio(os.path.join(base, rt)) for rt in room_types
            if os.path.isdir(os.path.join(base, rt))}
