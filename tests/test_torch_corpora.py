"""The port's corpus functions (xvector_tpu_torch/data/corpora.py) against
the JAX package's, on identical synthetic LDC/NIST trees.

Every case of tests/test_corpora.py runs here with its own assertions on
the port's output, and the port's output must equal the JAX package's
exactly (no tolerance: these are strings): utterances, ``utt2spk``,
``spk2utt``, ``wav`` entries (pipes and ``#chN`` suffixes included),
``spk2gender``, trial lists, ``trials_by_lang`` and ``utt2lang``.  Then
randomised trees from a seeded numpy generator, holding every function to
the JAX package's on each, and the three layouts of the SRE16 evaluation
key."""

import os
import warnings

import numpy as np
import pytest

from xvector_tpu.data import corpora as JC
from xvector_tpu.io import datadir as JD
from xvector_tpu_torch.data import corpora as PC
from xvector_tpu_torch.io import datadir as PD

from test_corpora import _mx6_layout, _sre_speaker_list, _touch


def assert_same(got, want, where="out"):
    """Equal structure and values; a DataDir of either package compares
    by its fields and its derived maps."""
    if isinstance(want, JD.DataDir):
        assert isinstance(got, PD.DataDir), where
        assert got.utts == want.utts, where
        assert got.utt2spk == want.utt2spk, where
        assert got.spk2utt == want.spk2utt, where
        assert got.speakers == want.speakers, where
        assert got.wav == want.wav, where
        assert got.spk2gender == want.spk2gender, where
        assert got.feats == want.feats and got.vad == want.vad, where
        assert got.utt2num_frames == want.utt2num_frames, where
    elif isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    else:
        assert type(got) is type(want) and got == want, where


def both(name, *args, **kw):
    """The port's function output, after holding it equal to the JAX
    package's on the same arguments."""
    got = getattr(PC, name)(*args, **kw)
    assert_same(got, getattr(JC, name)(*args, **kw), name)
    return got


# ---- the cases of tests/test_corpora.py ----------------------------------

def test_make_speaker_tree(tmp_path):
    for spk in ("id001", "id002"):
        for i in range(3):
            _touch(str(tmp_path / spk / "sess" / f"utt{i}.wav"))
    dd = both("make_speaker_tree", str(tmp_path))
    assert len(dd) == 6
    assert dd.speakers == ["id001", "id002"]
    assert dd.utt2spk["id001-utt0"] == "id001"
    assert dd.wav["id002-utt2"].endswith("utt2.wav")


def test_make_musan(tmp_path):
    for cat in ("music", "noise", "speech"):
        for i in range(2):
            _touch(str(tmp_path / cat / "sub" / f"{cat}{i}.wav"))
    out = both("make_musan", str(tmp_path))
    assert set(out) == {"music", "noise", "speech"}
    dd = out["noise"]
    assert len(dd) == 2
    for u, s in dd.utt2spk.items():
        assert u == s and u.startswith("noise-")


def test_make_rirs(tmp_path):
    for room in ("smallroom", "mediumroom"):
        for i in range(2):
            _touch(str(tmp_path / "simulated_rirs" / room / f"r{i}.wav"))
    rirs = both("make_rirs", str(tmp_path))
    assert set(rirs) == {"smallroom", "mediumroom"}
    assert len(rirs["smallroom"]) == 2


def test_make_sre16_eval(tmp_path):
    docs = tmp_path / "docs"
    os.makedirs(docs)
    (docs / "sre16_eval_enrollment.tsv").write_text(
        "modelid\tsegmentid\n1001\tsegA\n1001\tsegB\n1002\tsegC\n")
    (docs / "sre16_eval_segment_key.tsv").write_text(
        "segmentid\tsubjectid\nsegT1\ts77\nsegT2\ts88\n")
    for seg in ("segA", "segB", "segC"):
        _touch(str(tmp_path / "data" / "enrollment" / f"{seg}.sph"))
    for seg in ("segT1", "segT2"):
        _touch(str(tmp_path / "data" / "test" / f"{seg}.sph"))
    enroll, test = both("make_sre16_eval", str(tmp_path))
    assert len(enroll) == 3
    assert enroll.utt2spk["1001-segA"] == "1001"
    assert len(test) == 2
    assert test.utt2spk["segT1"] == "s77"


def test_make_sre16_unlabeled(tmp_path):
    for i in range(3):
        _touch(str(tmp_path / "data" / "unlabeled" / "major" / f"u{i}.sph"))
    dd = both("make_sre16_unlabeled", str(tmp_path))
    assert len(dd) == 3
    assert all(u == s for u, s in dd.utt2spk.items())


def test_make_sre18(tmp_path):
    docs = tmp_path / "docs"
    os.makedirs(docs)
    (docs / "sre18_dev_enrollment.tsv").write_text(
        "modelid\tsegmentid\tside\n"
        "m1\tsegA.sph\ta\nm1\tsegB.flac\ta\nm2\tsegC.sph\ta\n")
    (docs / "sre18_dev_trial_key.tsv").write_text(
        "modelid\tsegmentid\tside\ttargettype\n"
        "m1\tsegT1.sph\ta\ttarget\nm2\tsegT1.sph\ta\tnontarget\n")
    for seg, ext in (("segA", "sph"), ("segB", "flac"), ("segC", "wav")):
        _touch(str(tmp_path / "data" / "enrollment" / f"{seg}.{ext}"))
    _touch(str(tmp_path / "data" / "test" / "segT1.sph"))
    _touch(str(tmp_path / "data" / "unlabeled" / "segU1.sph"))
    out = both("make_sre18", str(tmp_path), "dev")
    enroll, test = out["enroll"], out["test"]
    assert len(enroll) == 3
    assert enroll.utt2spk["m1-segA"] == "m1"
    # flac routes through an ffmpeg decode pipe, sph stays a direct path
    assert enroll.wav["m1-segB"] == (
        f"ffmpeg -v 0 -i {tmp_path}/data/enrollment/segB.flac -f wav "
        "-ar 8000 - |")
    assert enroll.wav["m1-segA"].endswith("segA.sph")
    assert enroll.wav["m2-segC"].endswith("segC.wav")
    assert test.utt2spk["segT1"] == "segT1"
    assert out["trials"] == [("m1", "segT1", 1), ("m2", "segT1", 0)]
    assert len(out["unlabeled"]) == 1
    wide = both("make_sre18", str(tmp_path), "dev", sampling_frequency="16k")
    assert "-ar 16000 - |" in wide["enroll"].wav["m1-segB"]


def test_load_trials(tmp_path):
    p = tmp_path / "trials"
    p.write_text("spk1 segA target\nspk1 segB nontarget\nspk2 segA target\n"
                 "short line\n")
    trials = both("load_trials", str(p))
    assert trials == [("spk1", "segA", 1), ("spk1", "segB", 0),
                      ("spk2", "segA", 1)]


def test_datadir_algebra_roundtrip(tmp_path):
    """DataDir save/load + combine/split, the port's against the JAX
    package's."""
    kw = dict(utt2spk={"a-1": "a", "a-2": "a", "b-1": "b"},
              wav={"a-1": "x.wav", "a-2": "y.wav", "b-1": "z.wav"},
              utt2num_frames={"a-1": 100, "a-2": 50, "b-1": 300})
    out = {}
    for name, mod in (("port", PD), ("jax", JD)):
        dd = mod.DataDir(**kw)
        path = str(tmp_path / name)
        dd.save(path)
        back = mod.load_data_dir(path)
        assert back.utt2spk == dd.utt2spk
        assert back.utt2num_frames == dd.utt2num_frames
        assert back.spk2utt == {"a": ["a-1", "a-2"], "b": ["b-1"]}
        shards = back.split(2)
        assert sum(len(s) for s in shards) == 3
        merged = shards[0].combine(shards[1])
        assert merged.utt2spk == dd.utt2spk
        assert back.filter_min_frames(80).utts == ["a-1", "b-1"]
        assert back.subset_speakers(2).speakers == ["a"]
        out[name] = (back, shards, merged, back.subset_utts(2, seed=3))
        for f in sorted(os.listdir(path)):
            out[name] += ((f, open(os.path.join(path, f)).read()),)
    assert_same(out["port"], out["jax"])


def test_make_call_corpus(tmp_path):
    for fid in ("sw_10001", "sw_10002"):
        _touch(str(tmp_path / "audio" / f"{fid}.sph"))
    callers = [("sw_10001", "A", "spkX"), ("sw_10001", "B", "spkY"),
               ("sw_10002", "A", "spkX"), ("missing", "A", "spkZ"),
               ("sw_10002", "2", "spkW")]
    dd = both("make_call_corpus", str(tmp_path / "audio"), callers)
    assert len(dd) == 4                      # missing file skipped
    assert dd.utt2spk["spkX-sw_10001-A"] == "spkX"
    assert dd.wav["spkY-sw_10001-B"].endswith("sw_10001.sph#ch1")
    assert dd.wav["spkW-sw_10002-2"].endswith("sw_10002.sph#ch1")
    path, ch = both("parse_channel_spec", dd.wav["spkY-sw_10001-B"])
    assert path.endswith(".sph") and ch == 1
    assert both("parse_channel_spec", "a/b.sph") == ("a/b.sph", None)


def test_load_callers_csv(tmp_path):
    p = tmp_path / "callers.csv"
    p.write_text("file_id,channel,speaker\nsw1,A,s1\nsw1,B,s2\n")
    rows = both("load_callers_csv", str(p))
    assert rows == [("sw1", "A", "s1"), ("sw1", "B", "s2")]
    p2 = tmp_path / "callers.tsv"          # tsv sniffing
    p2.write_text("file_id\tchannel\tspeaker\nsw9\tB\ts7\n")
    assert both("load_callers_csv", str(p2)) == [("sw9", "B", "s7")]
    p3 = tmp_path / "callers.psv"          # other column names, pipes
    p3.write_text("conv|side|pin\nsw4|A|s4\n")
    assert both("load_callers_csv", str(p3), file_col="conv",
                channel_col="side", speaker_col="pin") == [("sw4", "A", "s4")]


def test_make_swbd_cellular(tmp_path):
    for conv in ("40000", "40019", "40021"):
        _touch(str(tmp_path / "data" / "audio" / f"sw_{conv}.sph"))
    os.makedirs(tmp_path / "doc")
    (tmp_path / "doc" / "swb_callstats.tbl").write_text(
        "40000,1001,1002,M,F\n"
        "40019,1003,1004,M,M\n"        # bad audio in part 1
        "40021,1001,1005,M,F\n"
        "40099,1006,1007,F,F\n")       # sph missing
    dd = both("make_swbd_cellular", str(tmp_path), version=1)
    assert len(dd) == 4                # 2 convs × 2 sides
    assert dd.utt2spk["sw_1001-swbdc_sw_40000_1"] == "sw_1001"
    assert dd.wav["sw_1002-swbdc_sw_40000_2"].endswith("sw_40000.sph#ch1")
    assert dd.spk2gender == {"sw_1001": "m", "sw_1002": "f", "sw_1005": "f"}
    # part 2: docs/ directory and a different bad-audio list
    os.makedirs(tmp_path / "docs")
    os.rename(tmp_path / "doc" / "swb_callstats.tbl",
              tmp_path / "docs" / "swb_callstats.tbl")
    dd2 = both("make_swbd_cellular", str(tmp_path), version=2)
    assert len(dd2) == 6               # 40019 allowed in part 2
    assert "sw_1003-swbdc_sw_40019_1" in dd2.utt2spk


def test_make_swbd2_phases(tmp_path):
    def layout(base, doc_name, callstat, callinfo=None):
        root = tmp_path / base
        for fid in ("sw_2001", "sw_2002"):
            _touch(str(root / "data" / "audio" / f"{fid}.sph"))
        os.makedirs(root / doc_name)
        (root / doc_name / "callstat.tbl").write_text(callstat)
        if callinfo is not None:
            (root / doc_name / "callinfo.tbl").write_text(callinfo)
        return str(root)

    r1 = layout("p1", "doc",
                "sw_2001.sph,x,301,302,x,M,F\n"
                "sw_2002.sph,x,303,304,x,F,M\n")
    d1 = both("make_swbd2_phase", r1, 1)
    assert len(d1) == 4
    assert d1.utt2spk["sw_301_sw_2001_1"] == "sw_301"
    assert d1.wav["sw_302_sw_2001_2"].endswith("sw_2001.sph#ch1")
    assert d1.spk2gender["sw_304"] == "m"

    r2 = layout("p2", "doc",
                "x,x,311,312,M,F\n"
                "x,x,313,314,F,M\n",
                callinfo=("sw_2001,a\nsw_2001,b\n"
                          "sw_2002,a\nsw_2002,b\n"))
    d2 = both("make_swbd2_phase", r2, 2)
    assert len(d2) == 4
    assert d2.utt2spk["sw_311_sw_2001_1"] == "sw_311"
    assert d2.spk2gender["sw_312"] == "f"

    r3 = layout("p3", "docs",
                "2001,x,x,321,322,M,F\n"
                "2002,x,x,323,324,F,M\n")
    d3 = both("make_swbd2_phase", r3, 3)
    assert len(d3) == 4
    assert d3.utt2spk["sw_321_sw_2001_1"] == "sw_321"
    assert d3.wav["sw_324_sw_2002_2"].endswith("sw_2002.sph#ch1")
    for mod in (PC, JC):
        with pytest.raises(ValueError, match="phase"):
            mod.make_swbd2_phase(r3, 4)


def test_make_mx6_calls(tmp_path):
    _mx6_layout(tmp_path)
    dd = both("make_mx6_calls", str(tmp_path))
    assert sorted(dd.utt2spk) == ["9003_MX6_777_A", "9004_MX6_777_B"]
    assert dd.wav["9003_MX6_777_A"].endswith("#ch0")
    assert dd.spk2gender == {"9003": "m", "9004": "f"}


def test_make_mx6_mic(tmp_path):
    _mx6_layout(tmp_path)
    dd = both("make_mx6_mic", str(tmp_path), "02")
    assert len(dd) == 2
    utt = "9001_MX6_20100100_130000_02"
    assert dd.utt2spk[utt] == "9001"
    # the sox pipe, verbatim: resample to 8k, trim to the interview
    flac = (f"{tmp_path}/data/pcm_flac/CH02/"
            "20100100_130000_LDC_9001_CH02.flac")
    assert dd.wav[utt] == (f"sox -t flac {flac} -r 8k -t wav - "
                           "trim 12.5 =300.0 |")
    for mod in (PC, JC):
        with pytest.raises(ValueError):
            mod.make_mx6_mic(str(tmp_path), "01")    # interviewer lapel


def test_make_mx6_combined(tmp_path):
    _mx6_layout(tmp_path)
    out = both("make_mx6", str(tmp_path), mic_subset=1)
    assert len(out["mic"]) == 3
    assert len(out["calls"]) == 2
    assert len(out["all"]) == 5
    assert out["all"].spk2gender["9001"] == "m"


def test_make_sre(tmp_path):
    ref = _sre_speaker_list(tmp_path)
    _touch(str(tmp_path / "c04" / "deep" / "xaaa.sph"))
    dd = both("make_sre", str(tmp_path / "c04"), "04", ref)
    assert sorted(dd.utt2spk) == ["spk1-sre04-xaaa-a", "spk2-sre04-xaaa-b"]
    assert dd.wav["spk2-sre04-xaaa-b"].endswith("xaaa.sph#ch1")
    assert dd.spk2gender == {"spk1": "f", "spk2": "m"}


def test_make_sre_04_to_06(tmp_path):
    ref = _sre_speaker_list(tmp_path)
    root = tmp_path / "corpora"
    _touch(str(root / "NIST" / "sre04" / "xaaa.sph"))
    _touch(str(root / "NIST" / "sre05" / "r101_1_1" / "train" / "xbbb.sph"))
    out = both("make_sre_04_to_06", str(root), ref)
    assert set(out) == {"sre2004", "sre2005_train"}
    assert len(out["sre2004"]) == 2
    assert out["sre2005_train"].utts == ["spk1-sre05-xbbb-a"]


def test_make_sre08(tmp_path):
    key_root, test_root, train_root = (tmp_path / "key", tmp_path / "test",
                                       tmp_path / "train")
    keys = key_root / "NIST_SRE08_KEYS.v0.1"
    os.makedirs(keys / "model-keys")
    os.makedirs(keys / "trial-keys")
    (keys / "model-keys" / "NIST_SRE08_short2.model.key").write_text(
        "m100,f,segE1:a,sid7\n"
        "m101,m,segE2:b,sid8\n")
    (keys / "trial-keys" / "NIST_SRE08_short2-short3.trial.key").write_text(
        "m100,segT1,a,target\n"
        "m100,segT2,b,nontarget\n"
        "m101,segT2,a,target\n")
    for root, seg in ((train_root, "segE1"), (train_root, "segE2"),
                      (test_root, "segT1"), (test_root, "segT2")):
        _touch(str(root / "data" / f"{seg}.sph"))
    dd = both("make_sre08", str(key_root), str(test_root), str(train_root))
    assert sorted(dd.utt2spk) == [
        "sid7_SRE08_segE1_A", "sid7_SRE08_segT1_A",
        "sid8_SRE08_segE2_B", "sid8_SRE08_segT2_A"]
    assert dd.utt2spk["sid7_SRE08_segT1_A"] == "sid7"
    assert dd.wav["sid8_SRE08_segE2_B"].endswith("segE2.sph#ch1")
    assert dd.spk2gender == {"sid7": "f", "sid8": "m"}


def test_make_sre10(tmp_path):
    root = tmp_path
    _touch(str(root / "data" / "segE1.sph"))
    _touch(str(root / "data" / "segT1.sph"))
    _touch(str(root / "data" / "16k" / "segT1.sph"))   # excluded duplicate
    os.makedirs(root / "keys")
    os.makedirs(root / "train")
    (root / "keys" / "coreext.modelkey.csv").write_text(
        "m200,sid10\nm201,NOT_SCORED\n")
    (root / "train" / "coreext.trn").write_text(
        "m200 f a/b/segE1.sph:A\n"
        "m201 m a/b/segE1.sph:B\n")
    (root / "keys" / "coreext-coreext.trialkey.csv").write_text(
        "m200,segT1,a,target,x\n"
        "m200,segT1,b,nontarget,x\n")
    dd = both("make_sre10", str(root))
    assert sorted(dd.utt2spk) == ["sid10_SRE10_segE1_A",
                                  "sid10_SRE10_segT1_A"]
    assert dd.spk2gender == {"sid10": "f"}
    assert "16k" not in dd.wav["sid10_SRE10_segT1_A"]


def test_spk2gender_roundtrip(tmp_path):
    out = {}
    for name, mod in (("port", PD), ("jax", JD)):
        dd = mod.DataDir(utt2spk={"a-1": "a", "b-1": "b"},
                         wav={"a-1": "x.wav", "b-1": "y.wav"},
                         spk2gender={"a": "m", "b": "f"})
        path = str(tmp_path / name)
        dd.save(path)
        back = mod.load_data_dir(path)
        assert back.spk2gender == {"a": "m", "b": "f"}
        only_a = back.filter(["a-1"])
        assert only_a.spk2gender == {"a": "m"}
        assert only_a.combine(back.filter(["b-1"])).spk2gender == \
            dd.spk2gender
        upper = back.map_speakers(lambda s: s.upper())
        assert upper.spk2gender == {"A": "m", "B": "f"}
        out[name] = (back, only_a, upper)
    assert_same(out["port"], out["jax"])


def test_load_wave_channel_suffix(tmp_path):
    """A ``#chN`` suffix selects channel N (0-based) of a two-channel
    SPHERE, in the port as in the JAX package."""
    from xvector_tpu.io import wav as JW
    from xvector_tpu_torch.io import wav as PW
    a = np.arange(50, dtype=np.int16)
    b = -np.arange(50, dtype=np.int16)
    inter = np.empty(100, dtype=np.int16)
    inter[0::2], inter[1::2] = a, b
    hdr_lines = ["NIST_1A", "   1024", "channel_count -i 2",
                 "sample_rate -i 8000", "sample_n_bytes -i 2",
                 "sample_byte_format -s2 01", "sample_coding -s3 pcm",
                 "end_head"]
    header = "\n".join(hdr_lines).encode() + b"\n"
    header += b" " * (1024 - len(header) - 1) + b"\n"
    p = tmp_path / "c.sph"
    p.write_bytes(header + inter.tobytes())
    for ch, want in ((0, a), (1, b)):
        s, rate = PW.load_wave(f"{p}#ch{ch}")
        np.testing.assert_array_equal(s, want.astype(np.float32))
        js, jrate = JW.load_wave(f"{p}#ch{ch}")
        np.testing.assert_array_equal(s, np.asarray(js))
        assert rate == jrate == 8000


def test_swbd_cellular_real_world_quirks(tmp_path):
    """Rows for convs whose audio is absent are skipped, extra trailing
    columns are ignored, the two call sides map to channels 0/1."""
    root = tmp_path / "LDC2001S13"
    (root / "doc").mkdir(parents=True)
    (root / "data" / "audio").mkdir(parents=True)
    (root / "data" / "audio" / "sw_40000.sph").write_bytes(b"")
    (root / "doc" / "swb_callstats.tbl").write_text(
        "40000,1001,1002,M,F,extra,columns,ignored\n"
        "40777,1005,1006,M,M\n"          # no audio on disk -> skipped
        "40019,1003,1004,M,M\n")         # bad-audio list -> skipped
    dd = both("make_swbd_cellular", str(root), version=1)
    assert set(dd.utt2spk) == {"sw_1001-swbdc_sw_40000_1",
                               "sw_1002-swbdc_sw_40000_2"}
    assert dd.wav["sw_1001-swbdc_sw_40000_1"].endswith("sw_40000.sph#ch0")
    assert dd.wav["sw_1002-swbdc_sw_40000_2"].endswith("sw_40000.sph#ch1")
    assert dd.spk2gender == {"sw_1001": "m", "sw_1002": "f"}


def test_unknown_gender_raises(tmp_path):
    """A call side whose gender is neither m nor f is an error in both."""
    (tmp_path / "doc").mkdir()
    _touch(str(tmp_path / "data" / "audio" / "sw_40000.sph"))
    (tmp_path / "doc" / "swb_callstats.tbl").write_text(
        "40000,1001,1002,M,X\n")
    for mod in (PC, JC):
        with pytest.raises(ValueError, match="unknown gender"):
            mod.make_swbd_cellular(str(tmp_path), version=1)


def test_failing_pipe_raises(tmp_path):
    """A ``cmd |`` entry whose command fails raises; it never yields
    silence (the Mixer 6 sox and SRE18 ffmpeg rows are such pipes)."""
    import subprocess
    from xvector_tpu_torch.io import wav as PW
    missing = tmp_path / "absent.flac"
    for spec in (f"sox -t flac {missing} -r 8k -t wav - trim 1 =2 |",
                 f"ffmpeg -v 0 -i {missing} -f wav -ar 8000 - |",
                 "false |"):
        with pytest.raises(subprocess.CalledProcessError):
            PW.load_wave(spec)


# ---- the SRE16 evaluation key in its three layouts -----------------------

def _sre16_tree(root, rng, n_spk=4, langs=("tgl", "yue")):
    """An SRE16 eval tree (docs/ enrollment + subject key, empty .sph) and
    its evaluation key (segment→call, call→language, trials) as
    separate text; returns (eval_root, key files)."""
    ev = root / "R149_0_1"
    (ev / "docs").mkdir(parents=True)
    enroll = ["modelid\tsegmentid"]
    subj = ["segmentid\tsubjectid"]
    seg_call, calls, trials = ["segmentid callid"], [], [
        "modelid segmentid side targettype"]
    tests = []
    for s in range(n_spk):
        for u in range(int(rng.randint(1, 4))):
            seg = f"en{s}{u}"
            _touch(str(ev / "data" / "enrollment" / f"{seg}.sph"))
            enroll.append(f"model{s}\t{seg}")
        for u in range(int(rng.randint(1, 4))):
            seg = f"te{s}{u}"
            _touch(str(ev / "data" / "test" / f"{seg}.sph"))
            subj.append(f"{seg}\tsubj{s}")
            tests.append((seg, s))
    for seg, s in tests:
        seg_call.append(f"{seg} call_{seg}")
        calls.append(f"call_{seg} {langs[int(rng.randint(len(langs)))]}")
        for m in range(n_spk):
            trials.append(f"model{m} {seg} a "
                          + ("target" if m == s else "nontarget"))
    (ev / "docs" / "sre16_eval_enrollment.tsv").write_text(
        "\n".join(enroll) + "\n")
    (ev / "docs" / "sre16_eval_segment_key.tsv").write_text(
        "\n".join(subj) + "\n")
    return ev, {"seg_call": seg_call, "calls": calls, "trials": trials,
                "subj": subj}


def _write_key(key, files, merged_segment_key=False):
    (key / "docs").mkdir(parents=True, exist_ok=True)
    (key / "metadata").mkdir(parents=True, exist_ok=True)
    if merged_segment_key:     # one rich key: subjectid and callid
        call = dict(line.split() for line in files["seg_call"][1:])
        rows = ["segmentid\tsubjectid\tcallid"] + [
            f"{line}\t{call[line.split()[0]]}" for line in files["subj"][1:]]
        (key / "docs" / "sre16_eval_segment_key.tsv").write_text(
            "\n".join(rows) + "\n")
    else:
        (key / "docs" / "sre16_eval_segment_key.tsv").write_text(
            "\n".join(files["seg_call"]) + "\n")
    (key / "metadata" / "calls.tsv").write_text(
        "\n".join(files["calls"]) + "\n")
    (key / "docs" / "sre16_eval_trial_key.tsv").write_text(
        "\n".join(files["trials"]) + "\n")


@pytest.mark.parametrize("layout", ["key_root", "download", "merged"])
@pytest.mark.parametrize("seed", [0, 1])
def test_sre16_eval_full_key_layouts(tmp_path, layout, seed):
    """The evaluation key found as an explicit ``key_root``, in the
    reference's ``<root>/../download/sre16_evaluation_key``, and merged
    into ``<root>/docs`` + ``<root>/metadata`` with one segment key that
    carries both subjectid and callid (picked by header)."""
    rng = np.random.RandomState(seed)
    ev, files = _sre16_tree(tmp_path, rng)
    key_root = None
    if layout == "key_root":
        key_root = str(tmp_path / "elsewhere" / "key")
        _write_key(tmp_path / "elsewhere" / "key", files)
    elif layout == "download":
        _write_key(tmp_path / "download" / "sre16_evaluation_key", files)
    else:
        _write_key(ev, files, merged_segment_key=True)
    full = both("make_sre16_eval_full", str(ev), key_root=key_root)
    n_test = len(files["subj"]) - 1
    assert len(full["trials"]) == 4 * n_test
    assert sum(label for _, _, label in full["trials"]) == n_test
    assert set(full["utt2lang"]) == set(full["test"].utts)
    assert set(full["trials_by_lang"]) == set(full["utt2lang"].values())
    assert sum(len(v) for v in full["trials_by_lang"].values()) \
        == len(full["trials"])


def test_sre16_eval_full_without_key_or_language_map(tmp_path):
    """No key: empty trial fields.  A trial key without the segment and
    language maps: trials come back, both packages warn, and every trial
    lands under "unknown"."""
    ev, files = _sre16_tree(tmp_path, np.random.RandomState(5))
    full = both("make_sre16_eval_full", str(ev))
    assert full["trials"] == [] and full["utt2lang"] == {}
    key = tmp_path / "download" / "sre16_evaluation_key"
    (key / "docs").mkdir(parents=True)
    (key / "docs" / "sre16_eval_trial_key.tsv").write_text(
        "\n".join(files["trials"]) + "\n")
    for mod in (PC, JC):
        with pytest.warns(UserWarning, match="per-language"):
            mod.make_sre16_eval_full(str(ev))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        full = both("make_sre16_eval_full", str(ev))
    assert len(full["trials"]) == 4 * (len(files["subj"]) - 1)
    assert list(full["trials_by_lang"]) == ["unknown"]


# ---- randomised LDC/NIST trees: every corpus function on each -------------

def _random_tree(root, rng):
    """One tree holding every delivery the corpus functions read, its sizes,
    genders and quirks drawn from ``rng``: SWBD cellular 1 and 2 (bad-
    audio convs, missing audio, extra columns), SWBD2 phases 1-3, Mixer 6
    (calls, mics 02 and 04-13, excluded rows), SRE04-06 under NIST/, SRE08
    keys, SRE10 (16k duplicates, NOT_SCORED models), SRE16 unlabeled,
    SRE18 dev with VAST flac, a speaker tree, MUSAN and RIRS, a callers
    csv and a trials file.  Returns the paths the functions take."""
    def gender():
        return "MF"[rng.randint(2)] if rng.rand() < 0.9 else "fm"[
            rng.randint(2)]

    paths = {}
    # Switchboard cellular 1 / 2
    for version, doc in ((1, "doc"), (2, "docs")):
        r = root / f"swbdc{version}"
        rows = []
        for i in range(int(rng.randint(3, 9))):
            conv = ("40019", "45024", "40022")[i] if i < 3 and \
                rng.rand() < 0.5 else str(40030 + 7 * i)
            if rng.rand() < 0.85:
                _touch(str(r / "data" / "audio" / f"sw_{conv}.sph"))
            extra = ",x,y" if rng.rand() < 0.3 else ""
            rows.append(f"{conv},{rng.randint(1000, 1050)},"
                        f"{rng.randint(1000, 1050)},{gender()}, {gender()}"
                        f"{extra}")
        (r / doc).mkdir(parents=True)
        (r / doc / "swb_callstats.tbl").write_text("\n".join(rows) + "\n")
        paths[f"swbdc{version}"] = str(r)
    # Switchboard-2 phases
    for phase in (1, 2, 3):
        r = root / f"swbd2p{phase}"
        doc = r / ("docs" if phase == 3 else "doc")
        doc.mkdir(parents=True)
        stat, info = [], []
        for i in range(int(rng.randint(2, 7))):
            fid = f"sw_{3000 + 11 * i}"
            if rng.rand() < 0.85:
                disc = f"disc{rng.randint(1, 3)}"
                _touch(str(r / disc / "data" / f"{fid}.sph"))
            s1, s2 = rng.randint(100, 160, size=2)
            if phase == 1:
                stat.append(f"{fid}.sph,x,{s1},{s2},x,{gender()},{gender()}")
            elif phase == 2:
                stat.append(f"x,x,{s1},{s2},{gender()},{gender()}")
                info += [f"{fid},a", f"{fid},b"]
            else:
                stat.append(f"{fid[3:]},x,x,{s1},{s2},{gender()},{gender()}")
        (doc / "callstat.tbl").write_text("\n".join(stat) + "\n")
        if phase == 2:
            (doc / "callinfo.tbl").write_text("\n".join(info) + "\n")
        paths[f"swbd2p{phase}"] = str(r)
    # Mixer 6
    r = root / "mx6"
    (r / "docs").mkdir(parents=True)
    subj = ["subjid,sex"] + [f"{9000 + s},{'MF'[s % 2]}" for s in range(8)]
    (r / "docs" / "mx6_subjs.csv").write_text("\n".join(subj) + "\n")
    calls = ["call_id,date_time,a,b,subjA,c,d,e,f,g,h,i,subjB"]
    for c in range(int(rng.randint(2, 5))):
        cid = str(500 + c)
        a, b = rng.randint(9000, 9008, size=2)
        calls.append(f"{cid},20100101_12000{c},a,b,{a},c,d,e,f,g,h,i,{b}")
        if rng.rand() < 0.8:
            _touch(str(r / "data" / "ulaw_sphere"
                       / f"20100101_12000{c}_{cid}_A.sph"))
    calls.append("short,row")
    (r / "docs" / "mx6_calls.csv").write_text("\n".join(calls) + "\n")
    iv = []
    for i in range(int(rng.randint(3, 7))):
        base = f"2010020{i}_14000{i}_LDC_{9000 + int(rng.randint(8))}"
        t1 = round(float(rng.uniform(0, 30)), 2)
        iv.append(f"{base},a,b,c,d,e,f,{t1},{t1 + 240.5}")
        for ch in ["02"] + [f"{m:02d}" for m in range(4, 14)]:
            if rng.rand() < 0.6:
                _touch(str(r / "data" / "pcm_flac" / f"CH{ch}"
                           / f"{base}_CH{ch}.flac"))
    iv.append("bad_base,a,b,c,d,e,f,1,2")
    (r / "docs" / "mx6_ivcomponents.csv").write_text("\n".join(iv) + "\n")
    paths["mx6"] = str(r)
    # SRE04-06 and the openslr speaker list
    r = root / "sre_root"
    parts = ["NIST/sre04", "NIST/sre05/r101_1_1/train",
             "NIST/sre05/r101_1_1/test", "NIST/sre06/r108_1_1/train",
             "NIST/sre06/r108_1_1/test"]
    years = ["2004", "2005", "2005", "2006", "2006"]
    lst = []
    for j, (part, year) in enumerate(zip(parts, years)):
        if rng.rand() < 0.2:
            continue
        for i in range(int(rng.randint(1, 4))):
            seg = f"x{j}{i}{'abc'[rng.randint(3)]}"
            if rng.rand() < 0.85:
                _touch(str(r / part / f"{seg}.sph"))
            for side in "AB"[: rng.randint(1, 3)]:
                lst.append(f"spk{rng.randint(20)} {'fm'[rng.randint(2)]} "
                           f"sre{year} {seg} {side}")
    lst.append("too short")
    (root / "speaker_list").write_text("\n".join(lst) + "\n")
    paths["sre_root"], paths["speaker_list"] = str(r), str(
        root / "speaker_list")
    # SRE08
    keys = root / "sre08key" / "NIST_SRE08_KEYS.v0.1"
    (keys / "model-keys").mkdir(parents=True)
    (keys / "trial-keys").mkdir(parents=True)
    mk, tk = [], []
    for m in range(int(rng.randint(2, 6))):
        seg = f"e08{m}"
        if rng.rand() < 0.9:
            _touch(str(root / "sre08train" / "data" / f"{seg}.sph"))
        mk.append(f"m{m},{'fm'[rng.randint(2)]},{seg}:{'ab'[rng.randint(2)]}"
                  f",sid{rng.randint(10)}")
        for t in range(int(rng.randint(1, 4))):
            tseg = f"t08{m}{t}"
            if rng.rand() < 0.8:
                _touch(str(root / "sre08test" / "data" / f"{tseg}.sph"))
            tk.append(f"m{m},{tseg},{'ab'[rng.randint(2)]},"
                      f"{('target', 'nontarget')[rng.randint(2)]}")
    (keys / "model-keys" / "NIST_SRE08_short2.model.key").write_text(
        "\n".join(mk) + "\nbad\n")
    (keys / "trial-keys" / "NIST_SRE08_short2-short3.trial.key").write_text(
        "\n".join(tk) + "\n")
    paths["sre08"] = tuple(str(root / n) for n in ("sre08key", "sre08test",
                                                   "sre08train"))
    # SRE10
    r = root / "sre10"
    (r / "keys").mkdir(parents=True)
    (r / "train").mkdir(parents=True)
    mkey, trn, trial = [], [], []
    for m in range(int(rng.randint(2, 6))):
        sid = "NOT_SCORED" if rng.rand() < 0.2 else f"sid{rng.randint(10)}"
        mkey.append(f"m{m},{sid}")
        seg = f"e10{m}"
        _touch(str(r / "data" / f"{seg}.sph"))
        if rng.rand() < 0.5:
            _touch(str(r / "data" / "16k" / f"{seg}.sph"))
        trn.append(f"m{m} {'fm'[rng.randint(2)]} x/y/{seg}.sph:"
                   f"{'AB'[rng.randint(2)]}")
        for t in range(int(rng.randint(1, 3))):
            tseg = f"t10{m}{t}"
            _touch(str(r / "data" / f"{tseg}.sph"))
            trial.append(f"m{m},{tseg},{'ab'[rng.randint(2)]},"
                         f"{('target', 'nontarget')[rng.randint(2)]},x")
    (r / "keys" / "coreext.modelkey.csv").write_text("\n".join(mkey) + "\n")
    (r / "train" / "coreext.trn").write_text("\n".join(trn) + "\n")
    (r / "keys" / "coreext-coreext.trialkey.csv").write_text(
        "\n".join(trial) + "\n")
    paths["sre10"] = str(r)
    # SRE16 unlabeled majors, SRE18 dev (VAST flac), a speaker tree
    for i in range(int(rng.randint(1, 5))):
        _touch(str(root / "sre16" / "data" / "unlabeled" / "major"
                   / f"mj{i}.sph"))
    paths["sre16"] = str(root / "sre16")
    r = root / "sre18"
    (r / "docs").mkdir(parents=True)
    enr = ["modelid\tsegmentid\tside"]
    tkey = ["modelid\tsegmentid\tside\ttargettype"]
    for m in range(int(rng.randint(2, 5))):
        ext = ("sph", "flac")[rng.randint(2)]
        seg = f"s18e{m}"
        if rng.rand() < 0.9:
            _touch(str(r / "data" / "enrollment" / f"{seg}.{ext}"))
        enr.append(f"m{m}\t{seg}.{ext}\ta")
        tseg = f"s18t{m}"
        _touch(str(r / "data" / "test" / f"{tseg}.{ext}"))
        tkey.append(f"m{m}\t{tseg}.{ext}\ta\t"
                    + ("target", "nontarget")[rng.randint(2)])
        _touch(str(r / "data" / "unlabeled" / f"s18u{m}.flac"))
    (r / "docs" / "sre18_dev_enrollment.tsv").write_text("\n".join(enr)
                                                         + "\n")
    (r / "docs" / "sre18_dev_trial_key.tsv").write_text("\n".join(tkey)
                                                        + "\n")
    paths["sre18"] = str(r)
    for s in range(int(rng.randint(1, 4))):
        for i in range(int(rng.randint(1, 4))):
            _touch(str(root / "vox" / f"id{s}" / f"sess{i % 2}"
                       / f"u{i}.wav"))
    paths["vox"] = str(root / "vox")
    # MUSAN and RIRS, a callers table, a trials file
    for cat in ("music", "noise", "speech"):
        if rng.rand() < 0.8:
            for i in range(int(rng.randint(1, 3))):
                _touch(str(root / "musan" / cat / "sub" / f"{cat}{i}.wav"))
    for room in ("smallroom", "mediumroom", "largeroom"):
        for i in range(int(rng.randint(0, 3))):
            _touch(str(root / "rirs" / "simulated_rirs" / room / "Room001"
                       / f"r{i}.wav"))
    paths["musan"], paths["rirs"] = str(root / "musan"), str(root / "rirs")
    (root / "callers.csv").write_text(
        "file_id,channel,speaker\n" + "".join(
            f"sw_{40030 + 7 * i},{'AB12'[rng.randint(4)]},c{i}\n"
            for i in range(6)))
    paths["callers"] = str(root / "callers.csv")
    (root / "trials").write_text("".join(
        f"m{rng.randint(5)} seg{i} {('target', 'nontarget')[rng.randint(2)]}"
        "\n" for i in range(10)))
    paths["trials"] = str(root / "trials")
    return paths


_BUILDERS = {
    "make_swbd_cellular_1": lambda p: ("make_swbd_cellular",
                                       (p["swbdc1"], 1)),
    "make_swbd_cellular_2": lambda p: ("make_swbd_cellular",
                                       (p["swbdc2"], 2)),
    "make_swbd2_phase_1": lambda p: ("make_swbd2_phase", (p["swbd2p1"], 1)),
    "make_swbd2_phase_2": lambda p: ("make_swbd2_phase", (p["swbd2p2"], 2)),
    "make_swbd2_phase_3": lambda p: ("make_swbd2_phase", (p["swbd2p3"], 3)),
    "make_mx6_calls": lambda p: ("make_mx6_calls", (p["mx6"],)),
    "make_mx6_mic_02": lambda p: ("make_mx6_mic", (p["mx6"], "02")),
    "make_mx6_mic_7": lambda p: ("make_mx6_mic", (p["mx6"], "7")),
    "make_mx6": lambda p: ("make_mx6", (p["mx6"], 3, 1)),
    "make_sre": lambda p: ("make_sre", (p["sre_root"] + "/NIST/sre04",
                                        "2004", p["speaker_list"])),
    "make_sre_04_to_06": lambda p: ("make_sre_04_to_06",
                                    (p["sre_root"], p["speaker_list"])),
    "make_sre08": lambda p: ("make_sre08", p["sre08"]),
    "make_sre10": lambda p: ("make_sre10", (p["sre10"],)),
    "make_sre16_unlabeled": lambda p: ("make_sre16_unlabeled",
                                       (p["sre16"],)),
    "make_sre18": lambda p: ("make_sre18", (p["sre18"], "dev")),
    "make_speaker_tree": lambda p: ("make_speaker_tree", (p["vox"],)),
    "make_speaker_tree_depth2": lambda p: ("make_speaker_tree",
                                           (p["vox"], 2)),
    "make_musan": lambda p: ("make_musan", (p["musan"],)),
    "make_rirs": lambda p: ("make_rirs", (p["rirs"],)),
    "make_call_corpus": lambda p: (
        "make_call_corpus",
        (p["swbdc1"], JC.load_callers_csv(p["callers"]))),
    "load_callers_csv": lambda p: ("load_callers_csv", (p["callers"],)),
    "load_trials": lambda p: ("load_trials", (p["trials"],)),
}


@pytest.fixture(scope="module", params=[0, 1, 2])
def random_tree(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"ldc{request.param}")
    return _random_tree(root, np.random.RandomState(100 + request.param))


@pytest.mark.parametrize("builder", sorted(_BUILDERS))
def test_builder_matches_jax_on_random_trees(random_tree, builder):
    name, args = _BUILDERS[builder](random_tree)
    both(name, *args)

