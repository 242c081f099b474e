"""The port's data-dir manifests (``xvector_tpu_torch/io/datadir.py``)
against the JAX package's: every operation of the algebra gives the same
maps (keys, strings and integers exactly), and a dir saved by either
package loads in the other to the same manifest."""

import dataclasses

import pytest

from xvector_tpu.io import datadir as JD
from xvector_tpu_torch.io import datadir as TD


def _maps(seed=0):
    utt2spk, wav, feats, vad, frames, gender = {}, {}, {}, {}, {}, {}
    for s in range(7):
        spk = f"spk{s}"
        gender[spk] = "mf"[s % 2]
        for u in range(1 + (3 * s + seed) % 5):
            utt = f"{spk}-u{u}"
            utt2spk[utt] = spk
            wav[utt] = f"sph2pipe -f wav {utt}.sph |"
            if (s + u) % 4:
                feats[utt] = f"raw_mfcc.ark:{100 * s + u}"
            vad[utt] = f"vad.ark:{7 * s + u}"
            frames[utt] = 120 * (u + 1) + 37 * s
    return utt2spk, wav, feats, vad, frames, gender


def _pair(seed=0):
    maps = _maps(seed)
    return TD.DataDir(*[dict(m) for m in maps]), \
        JD.DataDir(*[dict(m) for m in maps])


def _same(t, j):
    assert isinstance(t, TD.DataDir)
    for f in dataclasses.fields(JD.DataDir):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert list(getattr(t, "utt2spk")) == list(getattr(j, "utt2spk"))
    assert t.utts == j.utts and t.speakers == j.speakers
    assert t.spk2utt == j.spk2utt and len(t) == len(j)


@pytest.mark.parametrize("op", [
    lambda d: d.filter([u for i, u in enumerate(d.utts) if i % 3]),
    lambda d: d.exclude(d.utts[::2]),
    lambda d: d.subset_utts(5, seed=3),
    lambda d: d.subset_speakers(3),
    lambda d: d.filter_min_frames(300),
    lambda d: d.map_speakers(lambda s: "x" + s[::-1]),
    lambda d: d.validate(),
    lambda d: d,
], ids=["filter", "exclude", "subset_utts", "subset_speakers",
        "filter_min_frames", "map_speakers", "validate", "identity"])
def test_algebra_matches_jax(op):
    t, j = _pair()
    _same(op(t), op(j))


def test_combine_split_and_labels_match_jax():
    t, j = _pair(0)
    t2, j2 = _pair(2)
    t3 = t.map_speakers(lambda s: s + "b")
    j3 = j.map_speakers(lambda s: s + "b")
    _same(t.combine(t2, t3), j.combine(j2, j3))
    for n in (1, 3, 4):
        ts, js = t.split(n), j.split(n)
        assert len(ts) == len(js) == n
        for a, b in zip(ts, js):
            _same(a, b)
    assert t.spk2int() == j.spk2int()
    assert t.utt2int() == j.utt2int()


def test_save_load_across_packages(tmp_path):
    t, j = _pair(1)
    t.save(str(tmp_path / "port"))
    j.save(str(tmp_path / "jax"))
    for name in ("utt2spk", "spk2utt", "wav.scp", "feats.scp", "vad.scp",
                 "utt2num_frames", "spk2gender"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    _same(TD.load_data_dir(str(tmp_path / "jax")),
          JD.load_data_dir(str(tmp_path / "port")))
    # only utt2spk: the optional maps come back empty
    TD.DataDir({"a": "s", "b": "s"}).save(str(tmp_path / "bare"))
    _same(TD.load_data_dir(str(tmp_path / "bare")),
          JD.load_data_dir(str(tmp_path / "bare")))
