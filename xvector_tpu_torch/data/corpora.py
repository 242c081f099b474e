"""Corpus manifest builders → :class:`~xvector_tpu_torch.io.datadir.DataDir`.

Own copy of ``xvector_tpu/data/corpora.py`` (pure Python, no device work):
typed builders in place of the reference's per-corpus data-prep scripts
(``local/make_*``).  Each builder walks an LDC/NIST delivery and returns a
DataDir whose wav map holds a direct file path (``#chN`` names a channel
of a two-channel call, 0-based) or a ``cmd |`` decode pipe, the contract
:func:`xvector_tpu_torch.io.wav.load_wave` consumes.

Builders:
* :func:`make_musan` — MUSAN music/noise/speech (reference
  ``local/make_musan.py:19-60``)
* :func:`make_rirs` — RIRS_NOISES simulated room impulse responses
  (consumed by ``run.sh:124-142`` reverberation)
* :func:`make_sre16_eval` / :func:`make_sre16_eval_full` — NIST SRE16
  eval enrollment + test, and the evaluation key's trials and languages
  (reference ``local/make_sre16_eval_BUT.pl:16-154``)
* :func:`make_sre16_unlabeled` — major-language unlabeled set
  (``local/make_sre16_unlabeled.pl``)
* :func:`make_sre18` — NIST SRE18 dev/eval enrollment + test + unlabeled
  partitions with trial keys (reference ``local/make_sre18_dev.py:64-175``
  and ``local/make_sre18_eval.py``)
* :func:`make_speaker_tree` — generic ``root/<spk>/.../file.wav`` layouts
* :func:`make_from_table` — fully generic: rows of (utt, spk, path)
* :func:`make_call_corpus` — two-channel calls from a callers table
* :func:`make_swbd_cellular` — Switchboard Cellular 1/2 call sides from
  ``swb_callstats.tbl`` (``local/make_swbd_cellular{1,2}_BUT.pl``)
* :func:`make_swbd2_phase` — Switchboard-2 phases 1-3 from
  ``callstat.tbl``/``callinfo.tbl`` (``local/make_swbd2_phase*_BUT.pl``)
* :func:`make_mx6_calls` / :func:`make_mx6_mic` / :func:`make_mx6` —
  Mixer 6 telephone + microphone portions
  (``local/make_mx6_{calls,mic}_BUT.pl``, ``local/make_mx6_BUT.sh``)
* :func:`make_sre` / :func:`make_sre_04_to_06` / :func:`make_sre08` /
  :func:`make_sre10` — NIST SRE 2004-2010 training corpora keyed by the
  openslr speaker list / NIST model+trial keys (``local/make_sre.pl``,
  ``make_sre_BUT.sh``, ``make_sre08_BUT.pl``, ``make_sre10.pl``)
* :func:`load_trials` — a Kaldi trials file
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Iterable, List, Optional, Tuple

from ..io.datadir import DataDir

__all__ = ["make_musan", "make_rirs", "make_sre16_eval",
           "make_sre16_unlabeled", "make_sre18", "make_speaker_tree",
           "make_from_table", "make_swbd_cellular", "make_swbd2_phase",
           "make_mx6_calls", "make_mx6_mic", "make_mx6", "make_sre",
           "make_sre_04_to_06", "make_sre08", "make_sre10",
           "make_sre16_eval_full", "make_call_corpus",
           "parse_channel_spec", "load_callers_csv", "load_trials"]

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


def make_speaker_tree(root: str, spk_depth: int = 1) -> DataDir:
    """``root/<spk>/**/file.wav`` → utt ``<spk>-<file>``; ``spk_depth``
    selects which path level below root is the speaker id (VoxCeleb: 1)."""
    rows = []
    root = os.path.abspath(root)
    for path in _walk_audio(root):
        rel = os.path.relpath(path, root).split(os.sep)
        if len(rel) <= spk_depth:
            continue
        spk = rel[spk_depth - 1]
        utt = f"{spk}-{_utt_id(path)}"
        rows.append((utt, spk, path))
    return make_from_table(rows)


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


def _sph_pipe(path: str, channel: int = 1) -> str:
    """sph2pipe-style decode spec (make_sre16_eval_BUT.pl:53 builds
    'sph2pipe -f wav -p -c N'); :func:`~xvector_tpu_torch.io.wav.load_wave`
    decodes SPHERE, shorten included, natively, so the path itself is the
    spec."""
    return path


def make_sre16_eval(root: str) -> Tuple[DataDir, DataDir]:
    """NIST SRE16 eval → (enrollment, test) DataDirs.

    Parses ``docs/sre16_eval_enrollment.tsv`` (modelid, segmentid) and
    ``docs/sre16_eval_segment_key.tsv`` (segmentid → subjectid);
    audio at ``data/enrollment|test/<segment>.sph``.  Enrollment speakers
    are model ids; test "speakers" fall back to the segment key's subject
    (used only for trial scoring bookkeeping).
    """
    docs = os.path.join(root, "docs")

    def read_tsv(name):
        with open(os.path.join(docs, name)) as f:
            return list(csv.DictReader(f, delimiter="\t"))

    enroll_rows = []
    for r in read_tsv("sre16_eval_enrollment.tsv"):
        seg = r["segmentid"]
        path = os.path.join(root, "data", "enrollment", seg + ".sph")
        enroll_rows.append((f"{r['modelid']}-{seg}", r["modelid"],
                            _sph_pipe(path)))
    test_rows = []
    for r in read_tsv("sre16_eval_segment_key.tsv"):
        seg = r["segmentid"]
        path = os.path.join(root, "data", "test", seg + ".sph")
        spk = r.get("subjectid", seg)
        test_rows.append((seg, spk, _sph_pipe(path)))
    return make_from_table(enroll_rows), make_from_table(test_rows)


def make_sre16_eval_full(root: str, key_root: Optional[str] = None
                         ) -> Dict[str, object]:
    """SRE16 eval with the evaluation-key artifacts the reference's
    builder also emits (make_sre16_eval_BUT.pl:80-140): pooled ``trials``
    [(model, segment, 0/1)], per-language ``trials_tgl``/``trials_yue``,
    and ``utt2lang`` (segment → tgl/yue via segment→call→language).

    ``key_root`` defaults to the reference's layout
    ``<root>/../download/sre16_evaluation_key``; pass None-existing paths
    and the trial fields come back empty (audio-only use)."""
    enroll, test = make_sre16_eval(root)
    out: Dict[str, object] = {"enroll": enroll, "test": test,
                              "trials": [], "trials_by_lang": {},
                              "utt2lang": {}}
    # the key files ship in several layouts: an explicit key_root, the
    # reference's <root>/../download/sre16_evaluation_key, or merged
    # straight into <root>/docs + <root>/metadata (post-eval LDC trees)
    roots = ([key_root] if key_root else []) + [
        os.path.join(root, "..", "download", "sre16_evaluation_key"),
        root]

    def find(*rel):
        for r in roots:
            p = os.path.join(r, *rel)
            if os.path.exists(p):
                return p
        return None

    trial_key = find("docs", "sre16_eval_trial_key.tsv")
    calls = find("metadata", "calls.tsv")
    if trial_key is None:
        return out
    # segment→call map: the evaluation key's segment file carries a call
    # column; the eval tree's own same-named file may instead carry only
    # subjectid (or both, post-eval merged trees) — pick by header
    utt2call = {}
    for r in roots:
        p = os.path.join(r, "docs", "sre16_eval_segment_key.tsv")
        if not os.path.exists(p):
            continue
        with open(p) as f:
            header = f.readline().split()
            if "callid" in header:
                ci = header.index("callid")
            elif len(header) >= 2 and header[1] != "subjectid":
                ci = 1      # reference layout: segmentid callid
            else:
                continue    # subject map, not a call map
            for line in f:
                toks = line.split()
                if len(toks) > ci and toks[0] != "segment":
                    utt2call[toks[0]] = toks[ci]
        if utt2call:
            break
    if not utt2call or calls is None:
        import warnings
        warnings.warn(
            "sre16 trial key found but segment/language maps missing — "
            "per-language (tgl/yue) splits will be empty", stacklevel=2)
    call2lang = {}
    if calls:
        with open(calls) as f:
            for line in f:
                toks = line.split()
                if len(toks) >= 2:
                    call2lang[toks[0]] = toks[1]
    trials: List[Tuple[str, str, int]] = []
    utt2lang: Dict[str, str] = {}
    with open(trial_key) as f:
        for line in f:
            toks = line.split()
            if len(toks) < 4 or toks[1] == "segment" \
                    or toks[0] == "modelid":
                continue
            model, seg, target = toks[0], toks[1], toks[3]
            trials.append((model, seg, 1 if target == "target" else 0))
            lang = call2lang.get(utt2call.get(seg, ""), "")
            if lang:
                utt2lang[seg] = lang
    # per-language split via the one canonical partitioner (unknown-
    # language trials land under "unknown" rather than vanishing)
    from ..utils.scores import partition_trials
    out.update(trials=trials, utt2lang=utt2lang,
               trials_by_lang=partition_trials(trials, utt2lang))
    return out


def make_sre16_unlabeled(root: str) -> DataDir:
    """SRE16 major-language unlabeled set: every segment its own speaker
    (local/make_sre16_unlabeled.pl semantics)."""
    adir = os.path.join(root, "data", "unlabeled", "major")
    rows = [(_utt_id(p), _utt_id(p), _sph_pipe(p))
            for p in _walk_audio(adir)]
    return make_from_table(rows)


def _sre18_audio_spec(path: str, sampling_frequency: str = "8k") -> str:
    """SRE18 audio entry: .sph/.wav decode natively; .flac (the VAST
    portion) goes through an ffmpeg resample pipe exactly as the reference
    builds it (make_sre18_dev.py:51-61)."""
    if not path.endswith(".flac"):
        return path
    rate = 8000 if sampling_frequency == "8k" else 16000
    return f"ffmpeg -v 0 -i {path} -f wav -ar {rate} - |"


def make_sre18(root: str, partition: str = "dev",
               sampling_frequency: str = "8k"
               ) -> Dict[str, object]:
    """NIST SRE18 ``dev``/``eval`` → dict with DataDirs ``enroll``,
    ``test``, (dev only) ``unlabeled``, plus ``trials`` rows.

    Mirrors ``local/make_sre18_dev.py:64-175`` / ``make_sre18_eval.py``:
    enrollment utts are ``<modelid>-<segment>`` keyed to the model id as
    speaker (docs/sre18_<p>_enrollment.tsv); test utts are their own
    speaker; the trial key (docs/sre18_<p>_trial_key.tsv, columns
    modelid/segmentid/.../targettype) becomes (enroll, test, label) rows.
    CMN2 .sph segments decode natively; VAST .flac goes via ffmpeg pipe.
    """
    docs = os.path.join(root, "docs")

    def read_tsv(name):
        p = os.path.join(docs, name)
        if not os.path.exists(p):
            return []
        with open(p) as f:
            return list(csv.DictReader(f, delimiter="\t"))

    def audio_index(sub):
        return {_utt_id(p): p
                for p in _walk_audio(os.path.join(root, "data", sub))}

    enroll_audio = audio_index("enrollment")
    enroll_rows = []
    for r in read_tsv(f"sre18_{partition}_enrollment.tsv"):
        seg = r["segmentid"].split(".")[0]
        if seg in enroll_audio:
            enroll_rows.append(
                (f"{r['modelid']}-{seg}", r["modelid"],
                 _sre18_audio_spec(enroll_audio[seg], sampling_frequency)))

    test_rows = [(seg, seg, _sre18_audio_spec(p, sampling_frequency))
                 for seg, p in sorted(audio_index("test").items())]

    trials = []
    for r in read_tsv(f"sre18_{partition}_trial_key.tsv"):
        seg = r["segmentid"].split(".")[0]
        label = 1 if r.get("targettype") == "target" else 0
        trials.append((r["modelid"], seg, label))

    out: Dict[str, object] = {"enroll": make_from_table(enroll_rows),
                              "test": make_from_table(test_rows),
                              "trials": trials}
    unlabeled_dir = os.path.join(root, "data", "unlabeled")
    if os.path.isdir(unlabeled_dir):
        out["unlabeled"] = make_from_table(
            [(seg, seg, _sre18_audio_spec(p, sampling_frequency))
             for seg, p in sorted(audio_index("unlabeled").items())])
    return out


def make_call_corpus(audio_root: str,
                     callers: Iterable[Tuple[str, str, str]]) -> DataDir:
    """Two-channel telephone-call corpora (the SWBD cellular/phase and
    SRE04-10 pattern the reference's ``local/make_swbd*.pl`` /
    ``make_sre_BUT.sh`` scripts parse from LDC tables): each .sph holds
    two call sides; a callers table assigns ``(file_id, channel A|B,
    speaker)``.

    Utterances are named ``<speaker>-<file_id>-<channel>`` (the Snyder
    convention), and the wav entry records the channel for the SPHERE
    decoder.
    """
    index = {}
    for p in _walk_audio(audio_root):
        index[_utt_id(p)] = p
    rows = []
    for file_id, channel, speaker in callers:
        if file_id not in index:
            continue
        ch = 0 if channel.upper() in ("A", "1") else 1
        utt = f"{speaker}-{file_id}-{channel.upper()}"
        rows.append((utt, speaker, f"{index[file_id]}#ch{ch}"))
    return make_from_table(rows)


def parse_channel_spec(spec: str) -> Tuple[str, Optional[int]]:
    """Split a ``path#chN`` wav entry into (path, channel)."""
    if "#ch" in spec:
        path, _, ch = spec.rpartition("#ch")
        return path, int(ch)
    return spec, None


def load_callers_csv(path: str, file_col: str = "file_id",
                     channel_col: str = "channel",
                     speaker_col: str = "speaker"
                     ) -> List[Tuple[str, str, str]]:
    """Generic caller-table loader for LDC-style CSV/TSV speaker keys."""
    out = []
    with open(path, newline="") as f:
        sample = f.read(4096)
        f.seek(0)
        dialect = csv.Sniffer().sniff(sample, delimiters=",\t|")
        for row in csv.DictReader(f, dialect=dialect):
            out.append((row[file_col], row[channel_col], row[speaker_col]))
    return out


# ---- Switchboard two-channel telephone corpora -----------------------------

def _sph_index(root: str) -> Dict[str, str]:
    """basename (no extension) → path for every .sph under root (the
    reference's ``find $db_base -name '*.sph'`` indexing pattern)."""
    return {_utt_id(p): p for p in _walk_audio(root)
            if p.lower().endswith(".sph")}


def _two_sides(rows, gender, conv_key: str, path: str, spk1: str, spk2: str,
               g1: str, g2: str, utt_fmt: str):
    """Emit both call sides of a two-channel conversation. ``utt_fmt`` has
    {spk}/{conv}/{side} slots; channels are 0-based in the ``#ch`` spec."""
    for side, (spk, g) in enumerate(((spk1, g1), (spk2, g2))):
        g = g.strip().lower()
        if g not in ("m", "f"):
            raise ValueError(f"unknown gender {g!r} for {conv_key}")
        utt = utt_fmt.format(spk=spk, conv=conv_key, side=side + 1)
        rows.append((utt, spk, f"{path}#ch{side}"))
        gender.setdefault(spk, g)


def make_swbd_cellular(root: str, version: int = 1) -> DataDir:
    """Switchboard Cellular part 1 (LDC2001S13) / part 2 (LDC2004S07).

    Parses ``doc(s)/swb_callstats.tbl`` rows
    ``conv_id,spkA,spkB,genderA,genderB,...`` into the two call sides of
    ``data/audio/sw_<conv>.sph``, utterances named
    ``sw_<spk>-swbdc_sw_<conv>_<side>`` (reference
    ``local/make_swbd_cellular1_BUT.pl:26-70``, ``..._cellular2_BUT.pl``;
    part-specific bad-audio lists at their line 24)."""
    doc = os.path.join(root, "doc" if version == 1 else "docs")
    bad = {"40019", "45024", "40022"} if version == 1 else {"45024", "40022"}
    audio = os.path.join(root, "data", "audio")
    rows: List[Tuple[str, str, str]] = []
    gender: Dict[str, str] = {}
    with open(os.path.join(doc, "swb_callstats.tbl")) as f:
        for line in f:
            a = [t.strip() for t in line.strip().split(",")]
            if len(a) < 5 or a[0] in bad:
                continue
            conv = "sw_" + a[0]
            path = os.path.join(audio, conv + ".sph")
            if not os.path.exists(path):
                continue
            _two_sides(rows, gender, conv, path,
                       "sw_" + a[1], "sw_" + a[2], a[3], a[4],
                       "{spk}-swbdc_{conv}_{side}")
    return make_from_table(rows, gender)


def make_swbd2_phase(root: str, phase: int) -> DataDir:
    """Switchboard-2 phase 1 (LDC98S75) / 2 (LDC99S79) / 3 (LDC2002S06).

    The three deliveries use different ``callstat.tbl`` column layouts and
    (phase 2) a parallel ``callinfo.tbl`` carrying the file ids — exactly
    the differences between ``local/make_swbd2_phase{1,2,3}_BUT.pl``.
    Utterances: ``sw_<spk>_<file>_<side>``; sph files are located by a
    recursive index so multi-disc layouts work."""
    if phase not in (1, 2, 3):
        raise ValueError("phase must be 1, 2 or 3")
    doc = os.path.join(root, "docs" if phase == 3 else "doc")
    sphs = _sph_index(root)
    rows: List[Tuple[str, str, str]] = []
    gender: Dict[str, str] = {}

    def record_iter():
        with open(os.path.join(doc, "callstat.tbl")) as f:
            if phase == 2:
                with open(os.path.join(doc, "callinfo.tbl")) as fi:
                    info = fi.read().splitlines()
                # callinfo has two lines (one per side) per callstat row;
                # the file id is the first field of either
                for i, line in enumerate(f):
                    a = [t.strip() for t in line.split(",")]
                    fid = info[2 * i + 1].split(",")[0].strip()
                    yield fid, a[2], a[3], a[4], a[5]
            else:
                for line in f:
                    a = [t.strip() for t in line.split(",")]
                    if phase == 1:
                        fid = a[0].split("/")[-1].split(".")[0]
                        if fid in ("3", "4"):       # bad audio list
                            continue
                        yield fid, a[2], a[3], a[5], a[6]
                    else:
                        fid = "sw_" + a[0]
                        yield fid, a[3], a[4], a[5], a[6]

    for fid, s1, s2, g1, g2 in record_iter():
        if fid not in sphs:
            continue
        _two_sides(rows, gender, fid, sphs[fid],
                   "sw_" + s1, "sw_" + s2, g1, g2,
                   "{spk}_{conv}_{side}")
    return make_from_table(rows, gender)


# ---- Mixer 6 (LDC2013S03) --------------------------------------------------

def _mx6_genders(root: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    with open(os.path.join(root, "docs", "mx6_subjs.csv")) as f:
        for line in f:
            toks = [t.strip() for t in line.split(",")]
            if len(toks) >= 2 and toks[1].lower() in ("m", "f"):
                out[toks[0]] = toks[1].lower()
    return out


def make_mx6_calls(root: str) -> DataDir:
    """Mixer 6 telephone portion: ``docs/mx6_calls.csv`` rows assign call
    sides A/B to subject ids; audio is ``data/ulaw_sphere/*_<call>.sph``
    2-channel μ-law SPHERE. Utterances ``<sid>_MX6_<call>_<A|B>``
    (reference ``local/make_mx6_calls_BUT.pl:42-88``)."""
    gender = _mx6_genders(root)
    call2sph = {}
    for base, p in _sph_index(os.path.join(root, "data",
                                           "ulaw_sphere")).items():
        toks = base.split("_")
        if len(toks) >= 3:
            call2sph[toks[2]] = p
    rows: List[Tuple[str, str, str]] = []
    with open(os.path.join(root, "docs", "mx6_calls.csv")) as f:
        for line in f:
            toks = [t.strip() for t in line.split(",")]
            if len(toks) < 13 or toks[0] not in call2sph:
                continue
            call_id, sph = toks[0], call2sph[toks[0]]
            for ch, sid in ((0, toks[4]), (1, toks[12])):
                side = "AB"[ch]
                rows.append((f"{sid}_MX6_{call_id}_{side}", sid,
                             f"{sph}#ch{ch}"))
    return make_from_table(rows, gender)


def make_mx6_mic(root: str, channel: str) -> DataDir:
    """Mixer 6 interview speech from one room microphone, trimmed to the
    interview segment and resampled to 8 kHz via a sox pipe (reference
    ``local/make_mx6_mic_BUT.pl:38-74``). Channels 01 (interviewer lapel)
    and often-silent 03/14 are rejected as in the reference."""
    ch = f"{int(channel):02d}"
    if ch in ("01", "03", "14"):
        raise ValueError(f"mic channel {ch} is excluded (lapel/silent)")
    gender = _mx6_genders(root)
    flac_dir = os.path.join(root, "data", "pcm_flac", f"CH{ch}")
    rows: List[Tuple[str, str, str]] = []
    with open(os.path.join(root, "docs", "mx6_ivcomponents.csv")) as f:
        for line in f:
            toks = [t.strip() for t in line.split(",")]
            if len(toks) < 9:
                continue
            base, t1, t2 = toks[0], toks[7], toks[8]
            parts = base.split("_")
            if len(parts) < 4:
                continue
            flac = os.path.join(flac_dir, f"{base}_CH{ch}.flac")
            if not os.path.exists(flac):
                continue
            spk = parts[3]
            utt = f"{spk}_MX6_{parts[0]}_{parts[1]}_{ch}"
            rows.append((utt, spk,
                         f"sox -t flac {flac} -r 8k -t wav - "
                         f"trim {t1} ={t2} |"))
    return make_from_table(rows, gender)


def make_mx6(root: str, mic_subset: int = 2000,
             seed: int = 0) -> Dict[str, DataDir]:
    """Full Mixer 6 prep (reference ``local/make_mx6_BUT.sh``): mics
    02 + a ``mic_subset``-utterance sample of mics 04-13 (channel
    diversity without duplicating every room mic), plus the telephone
    portion; ``all`` is their union."""
    mics = ["02"] + [f"{m:02d}" for m in range(4, 14)]
    per_mic = {m: make_mx6_mic(root, m) for m in mics}
    rest = per_mic["04"].combine(*[per_mic[m] for m in mics[2:]])
    mic = per_mic["02"].combine(rest.subset_utts(mic_subset, seed=seed))
    calls = make_mx6_calls(root)
    return {"mic": mic, "calls": calls, "all": mic.combine(calls)}


# ---- NIST SRE 2004-2010 ----------------------------------------------------

def make_sre(root: str, year: str, speaker_list: str) -> DataDir:
    """One NIST SRE 04/05/06 partition keyed by the openslr ``speaker_list``
    file (rows ``<speaker> <gender> sre20YY <utt_id> <A|B>``), matching
    segments to .sph files found under ``root`` (reference
    ``local/make_sre.pl:23-58``). Utterances
    ``<spk>-sre<yy>-<utt>-<a|b>``."""
    year = year[-2:]
    sphs = _sph_index(root)
    rows: List[Tuple[str, str, str]] = []
    gender: Dict[str, str] = {}
    with open(speaker_list) as f:
        for line in f:
            toks = line.split()
            if len(toks) < 5:
                continue
            spk, g, sre_year, utt_id, side = toks[:5]
            if sre_year != f"sre20{year}" or utt_id not in sphs:
                continue
            ch = 0 if side.upper() == "A" else 1
            rows.append((f"{spk}-sre{year}-{utt_id}-{side.lower()}", spk,
                         f"{sphs[utt_id]}#ch{ch}"))
            gender.setdefault(spk, g.lower())
    return make_from_table(rows, gender)


def make_sre_04_to_06(data_root: str, speaker_list: str
                      ) -> Dict[str, DataDir]:
    """The SRE04-06 partitions of ``local/make_sre_BUT.sh:16-30`` under a
    NIST tree (``NIST/sre04``, ``NIST/sre05/r101_1_1/{train,test}``,
    ``NIST/sre06/r108_1_1/{train,test}``); missing partitions are
    skipped."""
    parts = {
        "sre2004": ("NIST/sre04", "04"),
        "sre2005_train": ("NIST/sre05/r101_1_1/train", "05"),
        "sre2005_test": ("NIST/sre05/r101_1_1/test", "05"),
        "sre2006_train": ("NIST/sre06/r108_1_1/train", "06"),
        "sre2006_test_1": ("NIST/sre06/r108_1_1/test", "06"),
    }
    out = {}
    for name, (sub, year) in parts.items():
        p = os.path.join(data_root, sub)
        if os.path.isdir(p):
            out[name] = make_sre(p, year, speaker_list)
    return out


def make_sre08(key_root: str, test_root: str, train_root: str) -> DataDir:
    """SRE08 enroll (LDC2011S05) + test (LDC2011S08) resolved to true
    speaker ids through the NIST key delivery: the short2 model key maps
    models → (gender, enrollment segment:side, speaker id); the
    short2-short3 trial key recovers test-segment speakers from target
    trials (reference ``local/make_sre08_BUT.pl:43-119``). Utterances
    ``<sid>_SRE08_<seg>_<A|B>``."""
    keys = os.path.join(key_root, "NIST_SRE08_KEYS.v0.1")
    sphs = {**_sph_index(os.path.join(test_root, "data")),
            **_sph_index(os.path.join(train_root, "data"))}
    rows: List[Tuple[str, str, str]] = []
    gender: Dict[str, str] = {}
    model2sid: Dict[str, str] = {}

    def add(sid, seg, side):
        ch = 0 if side.lower() == "a" else 1
        rows.append((f"{sid}_SRE08_{seg}_{side.upper()}", sid,
                     f"{sphs[seg]}#ch{ch}"))

    with open(os.path.join(keys, "model-keys",
                           "NIST_SRE08_short2.model.key")) as f:
        for line in f:
            toks = [t.strip() for t in line.split(",")]
            if len(toks) < 4:
                continue
            model, g, seg_ch, sid = toks[:4]
            seg, _, side = seg_ch.partition(":")
            model2sid[model] = sid
            gender.setdefault(sid, g.lower())
            if seg in sphs and side.lower() in ("a", "b"):
                add(sid, seg, side)
    with open(os.path.join(keys, "trial-keys",
                           "NIST_SRE08_short2-short3.trial.key")) as f:
        for line in f:
            toks = [t.strip() for t in line.split(",")]
            if len(toks) < 4:
                continue
            model, seg, side, target = toks[:4]
            if (target == "target" and model in model2sid and seg in sphs
                    and side.lower() in ("a", "b")):
                add(model2sid[model], seg, side)
    return make_from_table(rows, gender)


def make_sre10(root: str) -> DataDir:
    """SRE10 coreext enroll + test in one directory via the eval delivery's
    model key, train list and trial key (reference
    ``local/make_sre10.pl:30-116``); 16 kHz duplicates are excluded from
    the sph index. Utterances ``<sid>_SRE10_<seg>_<A|B>``."""
    sphs = {b: p
            for b, p in _sph_index(os.path.join(root, "data")).items()
            if f"{os.sep}16k{os.sep}" not in p}
    rows: List[Tuple[str, str, str]] = []
    gender: Dict[str, str] = {}
    model2sid: Dict[str, str] = {}
    with open(os.path.join(root, "keys", "coreext.modelkey.csv")) as f:
        for line in f:
            model, _, sid = line.strip().partition(",")
            if sid and sid != "NOT_SCORED":
                model2sid[model] = sid

    def add(sid, seg, side):
        ch = 0 if side.lower() == "a" else 1
        rows.append((f"{sid}_SRE10_{seg}_{side.upper()}", sid,
                     f"{sphs[seg]}#ch{ch}"))

    with open(os.path.join(root, "train", "coreext.trn")) as f:
        for line in f:
            toks = line.split()
            if len(toks) < 3 or toks[0] not in model2sid:
                continue
            model, g = toks[0], toks[1]
            fname = toks[2].split("/")[-1]
            sph, _, side = fname.partition(":")
            seg = sph.split(".")[0]
            sid = model2sid[model]
            gender.setdefault(sid, g.lower())
            if seg in sphs and side.lower() in ("a", "b"):
                add(sid, seg, side)
    with open(os.path.join(root, "keys", "coreext-coreext.trialkey.csv")) as f:
        for line in f:
            toks = [t.strip() for t in line.split(",")]
            if len(toks) < 4:
                continue
            model, seg, side, target = toks[:4]
            if (target == "target" and model in model2sid and seg in sphs
                    and side.lower() in ("a", "b")):
                add(model2sid[model], seg, side)
    return make_from_table(rows, gender)


def load_trials(path: str) -> List[Tuple[str, str, int]]:
    """Kaldi trials file ``<enroll> <test> target|nontarget`` →
    (enroll, test, label) rows (run.sh:281-293 scoring input)."""
    out = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 3:
                out.append((parts[0], parts[1],
                            1 if parts[2] == "target" else 0))
    return out
