"""End-to-end recipe driver: augment → features → egs → train → extract
→ score.

Counterpart of ``xvector_tpu/cli/run.py``: the programmatic equivalent of
the reference's shell recipe (``run.sh:39-313`` stages 0-10 +
``run_xvector.sh`` stages 4-6), a :class:`Recipe` whose stage methods are
idempotent and re-runnable, mirroring the ``--stage`` gating discipline,
with typed configs instead of parse_options.sh flag soup.

Stages: :meth:`Recipe.augment` (reverb/noise/music/babble copies, the
math on the device), :meth:`Recipe.make_features` (batched MFCC and
energy VAD on the device, compressed feature arks), :meth:`Recipe.make_egs`
(filters, hold-out, the chunk allocator, XTA archives through libxta, or
ranges files for ``stream_egs``), :meth:`Recipe.train` (the
:class:`~xvector_tpu_torch.train.trainer.Trainer`, K2-K4 on the card),
:meth:`Recipe.extract` / :meth:`Recipe.extract_from_wav` (x-vectors, K1
in bf16 wherever the topology supports it), :meth:`Recipe.score` and
:meth:`Recipe.score_sre16` (LDA, PLDA, adaptation, EER/minDCF).  Every
stage runs on ``RecipeConfig.device`` (``"cuda"`` unless the caller asks
for ``"cpu"``).

Data prep (reference stages 0-2, the corpus-specific manifest scripts) is
out of scope here: this driver starts from raw waveforms
(``wav_provider``) or a Kaldi data dir.  Dither draws from one
``torch.Generator`` on the device seeded with ``dither_seed``, so its
bits differ from the JAX package's ``jax.random`` draws.

At 2,000 training speakers or more, the PLDA EM runs on the device
(:func:`~xvector_tpu_torch.backend.plda_device.train_plda_device`); below
that the float64 host EM wins.  Trial scoring is the host's float64
:meth:`Plda.score_trials`, as upstream.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures as cf
import glob
import json
import os
import shutil
from dataclasses import dataclass, replace
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..backend import metrics as metricslib
from ..backend import plda as pldalib
from ..backend.plda_device import train_plda_device
from ..data import allocator as alloclib
from ..data import archives as archlib
from ..extract.extractor import (ExtractorConfig, WaveExtractor,
                                 WaveExtractorConfig, XvectorExtractor,
                                 pack_wave_batch, preprocess, speaker_means)
from ..io import kaldi_ark as kio
from ..io.datadir import DataDir
from ..models import tdnn
from ..ops import features as featlib
from ..ops import tdnn_kernel
from ..parallel import launch
from ..runtime import native
from ..train.trainer import TrainConfig, Trainer

__all__ = ["RecipeConfig", "Recipe", "main"]

# the device EM's batched sufficient-statistic formulation stays flat as the
# speaker count grows; the f64 host loop wins on small sets
DEVICE_EM_MIN_SPEAKERS = 2000


@dataclass(frozen=True)
class RecipeConfig:
    work_dir: str
    mfcc: featlib.MfccConfig = featlib.MfccConfig()
    vad: featlib.VadConfig = featlib.VadConfig()
    cmvn_window: int = 300
    # drop too-short utts: STRICTLY-GREATER contract, an utterance is
    # kept iff frames > min_utt_frames (run.sh:199-201 `awk '$2 > min_len'`).
    # CLIs targeting reference parity pass min_chunk-1 so a minimum-size
    # chunk still fits (the reference passes 500 = 400+100 headroom)
    min_utt_frames: int = 50
    min_spk_utts: int = 2             # keep speakers with >= this many
    #                                   utts (run.sh:208-211, 8 at scale)
    allocator: alloclib.AllocatorConfig = alloclib.AllocatorConfig()
    # 0 = derive from the get_egs.sh:120 formula at make_egs time:
    # num_train_frames * num_repeats / frames_per_iter + 1
    num_archives: int = 4
    num_valid_utts: int = 20          # get_egs.sh:44 holdout (200 at scale)
    train: TrainConfig = TrainConfig(num_targets=1)   # targets auto-set
    # extraction settings; its use_fused is decided by the stage: K1
    # wherever compute_dtype is bfloat16 and the topology supports it
    extractor: ExtractorConfig = ExtractorConfig()
    lda_dim: int = 0                  # 0 = skip LDA in score (run.sh: 100)
    plda_em_iters: int = 10
    # store raw MFCC arks as Kaldi CompressedMatrix (~4x smaller), the
    # make_mfcc.sh --compress=true default; the egs ark stays float32 for
    # native random access
    compress_feats: bool = True
    # featurization batch: waves per device batch (the batched masked
    # mfcc_batch/energy_vad_batch front end replaces the reference's
    # nj=40 make_mfcc.sh job fan-out, run.sh:97)
    feature_batch_size: int = 16
    feature_decode_workers: int = 4
    # True: skip .xta materialisation; training streams minibatches
    # straight from the egs feature ark via each archive's ranges file
    # (the reference's scp DataLoader path; same minibatch sequence)
    stream_egs: bool = False
    device: str = "cuda"              # where every stage's tensors live


class Recipe:
    def __init__(self, cfg: RecipeConfig):
        self.device = resolve_device(cfg.device)  # no card: raise unless cpu
        self.cfg = cfg
        # augmented-utt → clean-utt map filled by augment(); consumed by
        # make_features for clean-VAD inheritance (exact, not name-based)
        self._aug_base: Dict[str, str] = {}
        # resolved archive count: set by make_egs (cfg.num_archives, or the
        # get_egs.sh:120 derivation when cfg.num_archives == 0)
        self.num_archives: Optional[int] = None
        os.makedirs(cfg.work_dir, exist_ok=True)

    # -- paths -------------------------------------------------------------
    def _p(self, *parts) -> str:
        return os.path.join(self.cfg.work_dir, *parts)

    def _train_plda(self, grouped: Dict[str, np.ndarray]) -> pldalib.Plda:
        if len(grouped) >= DEVICE_EM_MIN_SPEAKERS:
            return train_plda_device(grouped,
                                     num_em_iters=self.cfg.plda_em_iters,
                                     device=self.cfg.device)
        return pldalib.train_plda(grouped,
                                  num_em_iters=self.cfg.plda_em_iters)

    # -- stage 0: augmentation (run.sh:113-171) -----------------------------
    def augment(self, data: DataDir,
                wav_provider: Callable[[str], np.ndarray],
                rirs=None,
                noises: Optional[list] = None,
                musics: Optional[list] = None,
                speeches: Optional[list] = None,
                kinds: Tuple[str, ...] = ("reverb", "noise", "music",
                                          "babble"),
                seed: int = 0):
        """Build the augmented corpus: each utterance gains one copy per
        available augmentation kind, named ``<utt>-<kind>`` so the chunk
        allocator's overlap control treats copies as the same recording
        (reference run.sh:144-171 + augment_data_dir.py naming).
        ``rirs`` is a list, or a mapping room type → list (sampled
        uniformly first).

        Returns (combined DataDir, provider) where the provider serves
        both clean and augmented waveforms on demand; each copy's picks
        come from a numpy generator seeded per utterance, its math runs on
        the recipe's device.
        """
        from ..ops import augment as auglib
        cfg = auglib.AugmentConfig()
        available = [k for k in kinds
                     if (k == "reverb" and rirs) or (k == "noise" and noises)
                     or (k == "music" and musics)
                     or (k == "babble" and speeches)]
        aug_utt2spk = dict(data.utt2spk)
        recipes: Dict[str, Tuple[str, str, int]] = {}
        rng = np.random.RandomState(seed)
        for utt in data.utts:
            for kind in available:
                aug_utt2spk[f"{utt}-{kind}"] = data.utt2spk[utt]
                recipes[f"{utt}-{kind}"] = (utt, kind, int(rng.randint(2**31)))
                self._aug_base[f"{utt}-{kind}"] = utt

        def provider(utt: str) -> np.ndarray:
            if utt in recipes:
                base, kind, sub_seed = recipes[utt]
                sub_rng = np.random.RandomState(sub_seed)
                return auglib.augment_utterance(
                    kind, np.asarray(wav_provider(base), np.float32),
                    sub_rng, cfg, rirs=rirs, noises=noises, musics=musics,
                    speeches=speeches, device=self.device)
            return wav_provider(utt)

        return DataDir(utt2spk=aug_utt2spk, wav=data.wav), provider

    # -- stage gating ------------------------------------------------------
    def force_from_stage(self, stage: int):
        """run.sh-style ``--stage`` semantics: clear the completed-artifact
        markers of every stage >= ``stage`` so those stages recompute,
        while earlier stages keep their outputs.  (The reference's
        ``[ $stage -le N ]`` blocks re-run unconditionally from the given
        stage, run.sh:39-313.)"""
        patterns = {
            1: ["feats_*.ark*", "vad_*.ark*"],
            2: ["egs_feats.ark*", "egs.*.xta", "egs.*.ranges", "pdf2num",
                "egs_info.json", "valid_egs.xta", "train_subset_egs.xta"],
            3: ["exp"],
            4: ["xvector_*.ark*", "xvector_*.scp*"],
        }
        for st, pats in patterns.items():
            if st < stage:
                continue
            for pat in pats:
                for path in glob.glob(self._p(pat)):
                    if os.path.isdir(path):
                        shutil.rmtree(path, ignore_errors=True)
                    else:
                        os.remove(path)

    # -- stage 1: features (run.sh:94-111 make_mfcc + vad) ------------------
    def _wave_bucket(self, n: int) -> int:
        """Waveform-length bucket: geometric spacing bounds the number of
        distinct batch shapes while capping padding waste at ~50%."""
        sr = self.cfg.mfcc.sample_rate
        b = sr  # 1 s
        while b < n:
            b = int(b * 1.5)
        return b

    def make_features(self, data: DataDir,
                      wav_provider: Callable[[str], np.ndarray],
                      split: str, dither_seed: Optional[int] = 0) -> DataDir:
        """Compute MFCC + VAD for every utterance; write feature/vad arks
        and return the data dir with feats/vad pointers. Idempotent.

        Waveforms decode on a small worker pool, get length-bucketed, and
        run through the batched masked front end (``mfcc_batch`` +
        ``energy_vad_batch``) on the device, ``feature_batch_size``
        utterances per batch, replacing the reference's 40-job
        ``make_mfcc.sh`` fan-out (``run.sh:97``).  ``dither_seed`` seeds
        the device generator that dither draws from; None turns dither
        off."""
        feat_ark = self._p(f"feats_{split}.ark")
        done = feat_ark + ".done"
        if not os.path.exists(done):
            gen = (torch.Generator(device=self.device).manual_seed(
                dither_seed) if dither_seed is not None else None)
            n_frames = {}
            vads: Dict[str, np.ndarray] = {}
            bsz = max(1, self.cfg.feature_batch_size)
            pending: Dict[int, list] = {}
            with kio.ArkWriter(feat_ark, feat_ark + ".scp",
                               compress=self.cfg.compress_feats) as fw:
                def flush(b: int):
                    items = pending.pop(b, [])
                    if not items:
                        return
                    # int16 wire format + rint/clip quantisation via the
                    # shared packer; the batch runs at its true size
                    waves, lens = pack_wave_batch(items, b, len(items))
                    with torch.inference_mode():
                        feats, mask = featlib.mfcc_batch(
                            torch.from_numpy(waves).to(self.device),
                            torch.from_numpy(lens).to(self.device),
                            self.cfg.mfcc, gen)
                        vad = featlib.energy_vad_batch(feats, mask,
                                                       self.cfg.vad)
                        t_i = mask.sum(1).to(torch.int64).cpu().numpy()
                        feats = feats.cpu().numpy()
                        vad = vad.cpu().numpy()
                    for i, (utt, _) in enumerate(items):
                        fw.write(utt, feats[i, : t_i[i]])
                        vads[utt] = vad[i, : t_i[i]]
                        n_frames[utt] = int(t_i[i])

                # bounded decode-ahead: a deque of in-flight futures keeps
                # the pool busy without materialising the whole corpus
                with cf.ThreadPoolExecutor(
                        max_workers=self.cfg.feature_decode_workers) as ex:
                    inflight = collections.deque()
                    utt_iter = iter(data.utts)

                    def refill():
                        while len(inflight) < 2 * max(
                                1, self.cfg.feature_decode_workers):
                            u = next(utt_iter, None)
                            if u is None:
                                return
                            inflight.append(
                                (u, ex.submit(wav_provider, u)))
                    refill()
                    while inflight:
                        utt, fut = inflight.popleft()
                        wave = np.asarray(fut.result(), np.float32)
                        b = self._wave_bucket(len(wave))
                        pending.setdefault(b, []).append((utt, wave))
                        if len(pending[b]) >= bsz:
                            flush(b)
                        refill()
                    for b in sorted(pending):
                        flush(b)
            # copies made by augment() inherit the CLEAN utterance's VAD —
            # the reference copies vad.scp from the clean list instead of
            # recomputing it on corrupted audio (run.sh:141, run.sh:172-175
            # comment); the explicit map avoids misfiring on corpora whose
            # genuine utt ids happen to contain '-'
            with kio.ArkWriter(self._p(f"vad_{split}.ark"),
                               self._p(f"vad_{split}.ark.scp")) as vw:
                for utt in data.utts:
                    base = self._aug_base.get(utt)
                    v = vads[utt]
                    if base is not None and base in vads \
                            and len(vads[base]) == len(v):
                        v = vads[base]
                    vw.write(utt, v)
            with open(done, "w") as f:
                json.dump(n_frames, f)
        with open(done) as f:
            n_frames = json.load(f)
        feats = _read_scp(feat_ark + ".scp")
        vads = _read_scp(self._p(f"vad_{split}.ark.scp"))
        return DataDir(data.utt2spk, data.wav, feats, vads,
                       {u: n_frames[u] for u in data.utt2spk
                        if u in n_frames})

    def _processed(self, data: DataDir, utt: str) -> torch.Tensor:
        """CMVN + voiced-frame-selected features for one utterance (the
        prepare_feats_for_egs.sh / extract pipe semantics), on the
        device."""
        feats = kio.read_mat(data.feats[utt])
        vad = kio.read_vec_flt(data.vad[utt]) if data.vad else None
        return preprocess(feats, self.cfg.cmvn_window, vad,
                          device=self.device)

    def _load_processed(self, data: DataDir, utt: str) -> np.ndarray:
        """:meth:`_processed` on the host, for the egs archives."""
        return self._processed(data, utt).cpu().numpy()

    # -- stage 2: egs (get_egs.sh) -----------------------------------------
    def _prepare_egs_feats(self, data: DataDir
                           ) -> Tuple[Dict[str, Tuple[str, int]],
                                      Dict[str, int]]:
        """Write CMVN'd + voiced-selected features to one ark
        (prepare_feats_for_egs.sh, run.sh:193) so egs materialisation can
        random-access them, natively via libxta where it is built.
        Idempotent."""
        ark = self._p("egs_feats.ark")
        scp = ark + ".scp"
        if not os.path.exists(ark + ".done"):
            with kio.ArkWriter(ark, scp) as w:
                for utt in data.utts:
                    w.write(utt, self._load_processed(data, utt))
            open(ark + ".done", "w").close()
        src = _read_scp_offsets(scp)
        if native.available():      # header-only probes
            usable = {u: native.mat_shape(path, off)[0]
                      for u, (path, off) in src.items()}
        else:
            usable = {u: v.shape[0] for u, v in kio.read_mat_scp(scp)}
        return src, usable

    def make_egs(self, data: DataDir) -> Tuple[DataDir, DataDir, int]:
        """Filter, hold out validation utts, allocate + materialise
        archives. Returns (train_dir, valid_dir, num_targets)."""
        cfg = self.cfg
        src, usable = self._prepare_egs_feats(data)
        usable = {u: usable[u] for u in data.utts if u in usable}
        # stage-3 filters (run.sh:197-212): strictly MORE than
        # min_utt_frames post-VAD frames (awk '$2 > min_len', min_len=500),
        # then speakers with >= min_spk_utts utterances (min_num_utts=8)
        keep = [u for u, n in usable.items()
                if n > cfg.min_utt_frames and n >= cfg.allocator.min_frames]
        n_all = len(usable)
        filtered = data.filter(keep)
        n_short = n_all - len(filtered)
        data = filtered.subset_speakers(cfg.min_spk_utts)
        n_sparse = len(filtered) - len(data)
        print(f"   egs filter: {n_all} utts -> dropped {n_short} short "
              f"(<= {cfg.min_utt_frames} voiced frames) + {n_sparse} from "
              f"sparse speakers (< {cfg.min_spk_utts} utts); kept "
              f"{len(data)} utts / {len(data.speakers)} speakers")
        valid = data.subset_utts(cfg.num_valid_utts, seed=7)
        train = data.exclude(valid.utts)
        # label space and num_targets come from the FULL filtered speaker
        # set, valid holdout included (get_egs.sh stage 0 builds spk2int
        # from ${data}/spk2utt before the holdout split)
        s2i = data.spk2int()
        utt2int = {u: s2i[s] for u, s in train.utt2spk.items()}
        num_targets = len(s2i)
        with open(self._p("pdf2num"), "w") as f:
            f.write(" ".join(str(i) for i in range(num_targets)))

        # archive count (get_egs.sh:120): num_frames*num_repeats/
        # frames_per_iter + 1 over the post-filter post-holdout train list
        num_train_frames = sum(usable[u] for u in train.utts)
        if cfg.num_archives and cfg.num_archives > 0:
            num_archives = cfg.num_archives
        else:
            num_archives = (num_train_frames * cfg.allocator.num_repeats
                            // cfg.allocator.frames_per_iter + 1)
        self.num_archives = num_archives
        with open(self._p("egs_info.json"), "w") as f:
            json.dump({"num_archives": num_archives,
                       "num_targets": num_targets,
                       "num_train_frames": int(num_train_frames)}, f)

        plans = alloclib.allocate_archives(
            {u: usable[u] for u in train.utts}, utt2int, cfg.allocator,
            num_archives=num_archives)
        cache: Dict[str, np.ndarray] = {}

        def fetch(utt):
            if utt not in cache:
                if len(cache) > 256:
                    cache.clear()
                cache[utt] = self._load_processed(train, utt)
            return cache[utt]

        for plan in plans:
            seed = cfg.allocator.seed + plan.index
            if cfg.stream_egs:
                rpath = self._p(f"egs.{plan.index}.ranges")
                if not os.path.exists(rpath):
                    with open(rpath + ".tmp", "w") as f:
                        f.write("\n".join(plan.to_ranges_lines()) + "\n")
                    os.replace(rpath + ".tmp", rpath)
                continue
            out_path = self._p(f"egs.{plan.index}.xta")
            if not archlib.materialize_archive_native(
                    plan, out_path, src, shuffle_seed=seed):
                archlib.materialize_archive(plan, out_path, fetch,
                                            shuffle_seed=seed)

        # diagnostic archives (get_egs.sh:44,100-106): held-out valid utts
        # + a train-subset probe, evaluated every iteration — labels from
        # the same full-speaker-set mapping as training
        def diag_archive(utts_dir: DataDir, name: str):
            u2i = {u: s2i[s] for u, s in utts_dir.utt2spk.items()
                   if s in s2i and usable.get(u, 0)
                   >= cfg.allocator.min_frames}
            if not u2i:
                return
            plans = alloclib.allocate_archives(
                {u: usable[u] for u in u2i}, u2i,
                alloclib.AllocatorConfig(
                    min_frames=cfg.allocator.min_frames,
                    max_frames=cfg.allocator.max_frames,
                    minibatch_size=min(cfg.allocator.minibatch_size,
                                       len(u2i)),
                    num_repeats=2, frames_per_iter=10 ** 5,
                    seed=cfg.allocator.seed),
                num_archives=1)
            for plan in plans:
                path = self._p(name)
                if not archlib.materialize_archive_native(plan, path, src):
                    archlib.materialize_archive(
                        plan, path, lambda u: self._load_processed(data, u))

        diag_archive(valid, "valid_egs.xta")
        diag_archive(train.subset_utts(cfg.num_valid_utts, seed=11),
                     "train_subset_egs.xta")
        return train, valid, num_targets

    def _resolved_num_archives(self) -> int:
        """Archive count: set by make_egs this run, else recovered from the
        persisted egs_info.json (resume without re-planning), else the
        configured value."""
        if self.num_archives is not None:
            return self.num_archives
        info = self._p("egs_info.json")
        if os.path.exists(info):
            with open(info) as f:
                return int(json.load(f)["num_archives"])
        if not self.cfg.num_archives or self.cfg.num_archives <= 0:
            raise ValueError("num_archives=0 (derive) but make_egs has not "
                             "run and no egs_info.json is present")
        return self.cfg.num_archives

    # -- stage 3: train (train_dnn.py) -------------------------------------
    def train(self, num_targets: int, mesh=None) -> Trainer:
        """Train on the materialised archives, or (``stream_egs``) on
        minibatches assembled from the egs feature ark at train time in
        the same order.  ``mesh`` (``parallel/mesh.py``) makes this process
        one rank of a multi-GPU run (``Trainer``'s launch contract: each
        rank reads whole archives and feeds its rows of every minibatch,
        ``parallel/launch.local_rows``)."""
        tcfg = replace(self.cfg.train, num_targets=num_targets)
        trainer = Trainer(tcfg, self._p("exp"),
                          feat_dim=self.cfg.mfcc.num_ceps,
                          device=self.device, mesh=mesh)

        # plans and the scp→offset map are identical across epochs/retries:
        # parse once, reuse every iteration
        stream_cache: Dict[int, alloclib.ArchivePlan] = {}
        stream_src: Dict[str, Tuple[str, int]] = {}

        def loader(batches):
            return launch.local_rows(batches, trainer.mesh)

        def archive_batches(i):
            if self.cfg.stream_egs:
                if not stream_src:
                    stream_src.update(_read_scp_offsets(
                        self._p("egs_feats.ark") + ".scp"))
                if i not in stream_cache:
                    with open(self._p(f"egs.{i}.ranges")) as f:
                        lines = f.read().splitlines()
                    stream_cache[i] = alloclib.ArchivePlan.from_ranges_lines(
                        i, lines,
                        length_bucket=self.cfg.allocator.length_bucket)
                return loader(archlib.stream_plan_loader(
                    stream_cache[i], utt2src=stream_src,
                    shuffle_seed=self.cfg.allocator.seed + i))
            reader = archlib.ArchiveReader(self._p(f"egs.{i}.xta"))
            return loader(archlib.PrefetchLoader(reader))

        def diag(name):
            p = self._p(name)
            if not os.path.exists(p):
                return None
            return lambda: loader(archlib.PrefetchLoader(
                archlib.ArchiveReader(p)))

        trainer.train(archive_batches, self._resolved_num_archives(),
                      valid_batches=diag("valid_egs.xta"),
                      train_subset_batches=diag("train_subset_egs.xta"))
        return trainer

    # -- stage 4: extract (extract_xvectors.sh) ----------------------------
    def _fused(self, model_cfg: tdnn.TdnnConfig) -> bool:
        """K1 takes bf16 operands: a bf16 run of a supported topology goes
        through it, an f32 run stays unfused (the extract CLI's rule)."""
        return (self.cfg.extractor.compute_dtype == "bfloat16"
                and tdnn_kernel.supports(model_cfg))

    def extract(self, trainer: Trainer, data: DataDir, split: str
                ) -> Dict[str, np.ndarray]:
        out_scp = self._p(f"xvector_{split}.scp")
        ark = self._p(f"xvector_{split}.ark")
        if os.path.exists(out_scp + ".done"):
            return dict(kio.read_vec_flt_scp(out_scp))
        ex = XvectorExtractor(
            trainer.model_cfg, trainer.params, trainer.state,
            replace(self.cfg.extractor,
                    use_fused=self._fused(trainer.model_cfg)),
            device=self.device)
        stream = ((u, self._processed(data, u)) for u in data.utts)
        with kio.ArkWriter(ark, out_scp) as w:
            result = {}
            for utt, xv in ex.extract_iter(stream):
                w.write(utt, xv)
                result[utt] = xv
        open(out_scp + ".done", "w").close()
        return result

    def extract_from_wav(self, trainer: Trainer, data: DataDir,
                         wav_provider: Callable[[str], np.ndarray],
                         split: str) -> Dict[str, np.ndarray]:
        """Waveform-direct extraction: per length bucket, one batch runs
        MFCC+VAD+CMVN+compaction+TDNN on the device (collapsing the
        reference's run.sh:97-101 + extract_xvectors.sh:68 pipe chain and
        forward).  No feature arks needed."""
        out_scp = self._p(f"xvector_wav_{split}.scp")
        ark = self._p(f"xvector_wav_{split}.ark")
        if os.path.exists(out_scp + ".done"):
            return dict(kio.read_vec_flt_scp(out_scp))
        ex = WaveExtractor(
            trainer.model_cfg, trainer.params, trainer.state,
            WaveExtractorConfig(
                min_chunk=self.cfg.extractor.min_chunk,
                max_chunk=self.cfg.extractor.max_chunk,
                batch_size=self.cfg.extractor.batch_size,
                cmvn_window=self.cfg.cmvn_window,
                compute_dtype=self.cfg.extractor.compute_dtype,
                use_fused=self._fused(trainer.model_cfg)),
            mfcc_cfg=self.cfg.mfcc, vad_cfg=self.cfg.vad, device=self.device)
        stream = ((u, np.asarray(wav_provider(u), np.float32))
                  for u in data.utts)
        result = {}
        with kio.ArkWriter(ark, out_scp) as w:
            for utt, xv in ex.extract_iter(stream):
                w.write(utt, xv)
                result[utt] = xv
        open(out_scp + ".done", "w").close()
        return result

    # -- stage 5: backend (run.sh:250-313) ---------------------------------
    def score(self, train_xv: Dict[str, np.ndarray], train_dir: DataDir,
              enroll_xv: Dict[str, np.ndarray],
              test_xv: Dict[str, np.ndarray],
              trials: Iterable[Tuple[str, str, int]],
              adapt_xv: Optional[Dict[str, np.ndarray]] = None,
              num_utts: Optional[Dict[str, int]] = None
              ) -> Dict[str, float]:
        """Train (and optionally adapt) the PLDA on training x-vectors,
        score (enroll, test, label) trials, return metrics.  ``num_utts``
        applies the multi-enroll LLR normalisation (run.sh:281-287)."""
        cfg = self.cfg
        mean = pldalib.global_mean(train_xv.values())

        lda = None
        if cfg.lda_dim > 0:
            spk_groups: Dict[str, list] = {}
            for u, v in train_xv.items():
                spk_groups.setdefault(train_dir.utt2spk[u], []).append(
                    np.asarray(v, np.float64))
            lda = pldalib.train_lda(
                {s: np.stack(vs) for s, vs in spk_groups.items()},
                dim=cfg.lda_dim)

        def prep(vecs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
            """center → (LDA) → length-norm, the run.sh:279-287 chain."""
            if lda is not None:
                arr = {k: lda(np.asarray(v, np.float64))
                       for k, v in vecs.items()}   # Lda centers internally
            else:
                arr = {k: np.asarray(v, np.float64) - mean
                       for k, v in vecs.items()}
            return {k: pldalib.length_normalize(v) for k, v in arr.items()}

        train_p = prep(train_xv)
        spk2vecs: Dict[str, list] = {}
        for u, v in train_p.items():
            spk2vecs.setdefault(train_dir.utt2spk[u], []).append(v)
        grouped = {s: np.stack(vs) for s, vs in spk2vecs.items()}
        model = self._train_plda(grouped)
        if adapt_xv:
            model = model.adapt(np.stack(list(prep(adapt_xv).values())))

        trials = list(trials)
        pairs = [(e, t) for e, t, _ in trials]
        labels = np.array([l for _, _, l in trials])
        llr = model.score_trials(prep(enroll_xv), prep(test_xv), pairs,
                                 num_utts=num_utts)
        return {"eer": metricslib.eer(llr, labels),
                "min_dcf": metricslib.min_dcf(llr, labels),
                "num_trials": len(trials),
                "scores": llr}

    # -- stage 5b: the full SRE16 back-end protocol (run.sh:250-313) -------
    def score_sre16(self, train_xv: Dict[str, np.ndarray],
                    train_dir: DataDir,
                    unlabeled_xv: Dict[str, np.ndarray],
                    enroll_xv: Dict[str, np.ndarray],
                    test_xv: Dict[str, np.ndarray],
                    trials: Iterable[Tuple[str, str, int]],
                    num_utts: Optional[Dict[str, int]] = None,
                    utt2cond: Optional[Dict[str, str]] = None,
                    lda_dim: int = 100) -> Dict[str, Dict]:
        """Orchestrates the reference's stages 8-10 end to end:

        * global mean from the UNLABELED in-domain majors (run.sh:252-254)
          — the eval-side centering uses this mean, while LDA/PLDA train
          on the labeled set centered on its OWN mean (the dual-mean
          protocol of run.sh:256-267 vs :279-287);
        * LDA to ``lda_dim`` (100) on the labeled set (run.sh:256-261);
        * PLDA on LDA'd + length-normalised labeled vectors (run.sh:263-267);
        * unsupervised PLDA adaptation on the majors (run.sh:269-276);
        * BOTH out-of-domain and adapted scoring with ``--num-utts``
          multi-enroll normalisation (run.sh:279-287, :297-305);
        * pooled + per-condition EER/minDCF (the per-language splits of
          run.sh:289-294, :309-312) via ``utt2cond`` on test segments.

        Returns ``{"out_of_domain": res, "adapted": res}`` where each res
        holds pooled metrics, ``scores`` (per-trial LLRs), and
        ``per_condition`` metrics when ``utt2cond`` is given.
        """
        trials = list(trials)
        pairs = [(e, t) for e, t, _ in trials]
        labels = np.array([l for _, _, l in trials])

        major_mean = pldalib.global_mean(unlabeled_xv.values())

        spk_groups: Dict[str, list] = {}
        for u, v in train_xv.items():
            spk_groups.setdefault(train_dir.utt2spk[u], []).append(
                np.asarray(v, np.float64))
        lda = pldalib.train_lda(
            {s: np.stack(vs) for s, vs in spk_groups.items()}, dim=lda_dim)

        # PLDA training chain: own-mean center (inside Lda) → LDA →
        # length-norm (run.sh:263-267)
        grouped = {s: np.stack([pldalib.length_normalize(lda(v))
                                for v in vs])
                   for s, vs in spk_groups.items()}
        model = self._train_plda(grouped)

        # eval chain: majors mean → LDA transform → length-norm
        # (run.sh:279-287; note transform-vec applies the LDA matrix to
        # the mean-subtracted vector, not Lda's own centering)
        def prep_eval(vecs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
            return {k: pldalib.length_normalize(
                (np.asarray(v, np.float64) - major_mean) @ lda.transform.T)
                for k, v in vecs.items()}

        enroll_p = prep_eval(enroll_xv)
        test_p = prep_eval(test_xv)
        adapted = model.adapt(
            np.stack(list(prep_eval(unlabeled_xv).values())))

        def evaluate(m) -> Dict:
            llr = m.score_trials(enroll_p, test_p, pairs,
                                 num_utts=num_utts)
            res = {"eer": metricslib.eer(llr, labels),
                   "min_dcf": metricslib.min_dcf(llr, labels),
                   "num_trials": len(trials),
                   "scores": llr}
            if utt2cond:
                per = {}
                for cond in sorted(set(utt2cond.values())):
                    idx = [i for i, (_, t, _) in enumerate(trials)
                           if utt2cond.get(t) == cond]
                    if idx:
                        per[cond] = {
                            "eer": metricslib.eer(llr[idx], labels[idx]),
                            "min_dcf": metricslib.min_dcf(llr[idx],
                                                          labels[idx]),
                            "num_trials": len(idx)}
                res["per_condition"] = per
            return res

        return {"out_of_domain": evaluate(model),
                "adapted": evaluate(adapted)}


def _read_scp(path: str) -> Dict[str, str]:
    """utt → rxfilename of a Kaldi scp."""
    with open(path) as f:
        return dict(line.split(None, 1) for line in f.read().splitlines())


def _read_scp_offsets(path: str) -> Dict[str, Tuple[str, int]]:
    """utt → (ark path, byte offset) of a ``<utt> <ark>:<offset>`` scp."""
    out = {}
    for utt, loc in _read_scp(path).items():
        ark, off = loc.rsplit(":", 1)
        out[utt] = (ark, int(off))
    return out


def _synthetic_corpus(num_spk: int, utts_per_spk: int, seed: int = 0):
    """Resonant-tone speakers (the e2e test corpus) for demo/smoke runs."""
    rng = np.random.RandomState(seed)
    sr = 8000
    f0 = rng.uniform(300, 3000, size=(num_spk, 2))
    waves, utt2spk = {}, {}
    for s in range(num_spk):
        for u in range(utts_per_spk):
            dur = int(sr * rng.uniform(1.8, 2.5))
            t = np.arange(dur) / sr
            w = sum(np.sin(2 * np.pi * f * t + rng.uniform(0, 6))
                    for f in f0[s])
            utt = f"spk{s}_utt{u}"
            waves[utt] = (3000 * w + 300 * rng.randn(dur)) \
                .astype(np.float32)
            utt2spk[utt] = f"spk{s}"
    return waves, utt2spk


class _LazyWaves:
    """List-like random-access view over audio paths: waves are decoded on
    demand, so corpus-scale MUSAN/RIR sets never sit in RAM at once.

    ``target_sr`` resamples on the fly (band-limited polyphase,
    io/wav.resample) when the stored rate differs — stock MUSAN/RIRS ship
    at 16 kHz while the SRE recipe runs at 8 kHz; the reference resamples
    via ``--source-sampling-rate`` (run.sh:135) / sox pipes."""

    def __init__(self, paths, target_sr: int | None = None):
        self._paths = list(paths)
        self._target_sr = target_sr

    def __len__(self):
        return len(self._paths)

    def __getitem__(self, i):
        from ..io.wav import load_wave, resample
        samples, sr = load_wave(self._paths[i])
        samples = np.asarray(samples, np.float32)
        if self._target_sr and sr and sr != self._target_sr:
            samples = resample(samples, sr, self._target_sr)
        return samples


def main(argv=None):
    """Staged end-to-end driver (run.sh stages, --stage gating):

      0 augment · 1 features · 2 egs · 3 train · 4 extract · 5 score

    Input: --data-dir (Kaldi data dir whose wav.scp the decoder can read)
    or --synthetic-speakers for a self-contained demo corpus.
    Augmentation (run.sh:113-171) activates when --musan-dir and/or
    --rirs-dir point at the MUSAN / RIRS_NOISES corpora.  Every stage runs
    on --device (default cuda).  On a host with several visible cards,
    stage 3 trains on all of them, one rank per card
    (``parallel/launch.run``): rank 0 alone runs stages 0-2 while the
    others wait, and stages 4-5 after training.
    """
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--work-dir", required=True)
    ap.add_argument("--musan-dir", default="",
                    help="MUSAN root (music/ noise/ speech/) for additive "
                         "augmentation, run.sh:146-163")
    ap.add_argument("--rirs-dir", default="",
                    help="RIRS_NOISES root for reverberation, "
                         "run.sh:118-136")
    ap.add_argument("--stage", type=int, default=-1,
                    help="force re-runs from this stage (run.sh gating): "
                         "completed artifacts of stages >= N are cleared "
                         "and recomputed; stages < N keep their artifacts. "
                         "Default -1 = idempotent auto-skip everywhere")
    ap.add_argument("--extract-from-wav", action="store_true",
                    help="stage 4 runs straight from waveforms (MFCC, VAD, "
                         "CMVN and the TDNN in one device batch per "
                         "bucket) instead of the feature arks")
    ap.add_argument("--data-dir", default="")
    ap.add_argument("--synthetic-speakers", type=int, default=0)
    ap.add_argument("--synthetic-utts", type=int, default=6)
    ap.add_argument("--model", default="no_dropout")
    ap.add_argument("--num-archives", type=int, default=2)
    ap.add_argument("--num-epochs", type=int, default=2)
    ap.add_argument("--lda-dim", type=int, default=0)
    ap.add_argument("--min-chunk", type=int, default=60)
    ap.add_argument("--max-chunk", type=int, default=120)
    ap.add_argument("--minibatch-size", type=int, default=8)
    ap.add_argument("--compute-dtype", default="bfloat16")
    ap.add_argument("--stream-egs", action="store_true",
                    help="skip .xta materialisation; stream minibatches "
                         "from the egs feature ark at train time")
    ap.add_argument("--device", default="cuda",
                    help="where every stage runs (cuda, or cpu)")
    args = ap.parse_args(argv)
    if not (args.synthetic_speakers or args.data_dir):
        ap.error("need --data-dir or --synthetic-speakers")
    return launch.run("xvector_tpu_torch.cli.run", argv, args.device,
                      args.work_dir,
                      lambda device, mesh: _run(args, device, mesh))


def _run(args, device, mesh):
    """``main``'s stages on ``device``, as one rank of ``mesh`` (or alone
    without one)."""
    from ..io.wav import load_wave

    if args.synthetic_speakers:
        waves, utt2spk = _synthetic_corpus(args.synthetic_speakers,
                                           args.synthetic_utts)
        data = DataDir(utt2spk=utt2spk)
        provider = lambda u: waves[u]
    else:
        from ..io.datadir import load_data_dir
        from ..io.wav import resample
        data = load_data_dir(args.data_dir)
        target_sr = featlib.MfccConfig().sample_rate

        def provider(u):
            samples, rate = load_wave(data.wav[u])
            if rate and rate != target_sr:
                samples = resample(samples, rate, target_sr)
            return samples

    preset = tdnn.REFERENCE_CLASS_TO_PRESET.get(args.model, args.model)
    cfg = RecipeConfig(
        work_dir=args.work_dir,
        min_utt_frames=args.min_chunk - 1,   # the filter is strict '>'
        num_valid_utts=max(2, len(data) // 10),
        num_archives=args.num_archives,
        allocator=alloclib.AllocatorConfig(
            min_frames=args.min_chunk, max_frames=args.max_chunk,
            minibatch_size=args.minibatch_size, num_repeats=3,
            frames_per_iter=10 ** 6, length_bucket=32),
        train=TrainConfig(model=preset, num_targets=1,
                          num_epochs=args.num_epochs,
                          compute_dtype=args.compute_dtype),
        extractor=ExtractorConfig(
            min_chunk=25, max_chunk=max(400, args.max_chunk),
            batch_size=8, compute_dtype=args.compute_dtype),
        lda_dim=args.lda_dim,
        stream_egs=args.stream_egs,
        device=str(device))
    recipe = Recipe(cfg)

    # the host stages: rank 0 alone, the other ranks wait outside any
    # collective
    with launch.Rank0Stage(mesh, args.work_dir, "egs") as stage:
        if stage.runs_here:
            data, provider = _augment(args, recipe, data, provider)
            if args.stage >= 0:
                print(f"== forcing re-run from stage {args.stage}")
                recipe.force_from_stage(args.stage)
            print(f"== stage 1: features ({len(data)} utts)")
            feat_dir = recipe.make_features(data, provider, split="all")
            print("== stage 2: egs")
            train_dir, valid_dir, num_targets = recipe.make_egs(feat_dir)
            print(f"   {num_targets} speakers, {recipe.num_archives} "
                  "archives")
            stage.result = {"num_targets": num_targets,
                            "num_archives": recipe.num_archives}
    recipe.num_archives = stage.result["num_archives"]
    if stage.runs_here:
        print("== stage 3: train")
    trainer = recipe.train(stage.result["num_targets"], mesh)
    if not launch.leave_group(mesh):
        return None
    print("== stage 4: extract"
          + (" (from wav)" if args.extract_from_wav else ""))
    if args.extract_from_wav:
        xv = recipe.extract_from_wav(trainer, feat_dir, provider,
                                     split="all")
    else:
        xv = recipe.extract(trainer, feat_dir, split="all")
    print(f"   {len(xv)} x-vectors -> {recipe.cfg.work_dir}")
    print("== stage 5: score (speaker-verification trials)")
    utts = sorted(xv)
    enroll = {u: xv[u] for i, u in enumerate(utts) if i % 2 == 0}
    test = {u: xv[u] for i, u in enumerate(utts) if i % 2 == 1}
    spk_enroll, num_utts = speaker_means(enroll, feat_dir.utt2spk)
    trials = [(s, t, 1 if feat_dir.utt2spk[t] == s else 0)
              for s in spk_enroll for t in test]
    train_xv = {u: xv[u] for u in train_dir.utts if u in xv}
    res = recipe.score(train_xv, train_dir, spk_enroll, test, trials,
                       num_utts=num_utts)
    print(f"   EER {res['eer']*100:.2f}%  minDCF {res['min_dcf']:.3f}  "
          f"({res['num_trials']} trials)")
    return res


def _augment(args, recipe, data, provider):
    """Stage 0 (run.sh:113-171): reverb, noise, music and babble copies
    where --rirs-dir or --musan-dir is given; else ``data`` as it is."""
    if not (args.musan_dir or args.rirs_dir):
        return data, provider
    from ..data import corpora
    sr = recipe.cfg.mfcc.sample_rate
    rirs = noises = musics = speeches = None
    if args.rirs_dir:
        rooms = corpora.make_rirs(args.rirs_dir)
        rirs = {room: _LazyWaves(paths, target_sr=sr)
                for room, paths in rooms.items() if paths} or None
    if args.musan_dir:
        musan = corpora.make_musan(args.musan_dir)

        def lazy(cat):
            if cat not in musan:
                return None
            dd = musan[cat]
            return _LazyWaves([dd.wav[u] for u in dd.utts],
                              target_sr=sr) or None

        noises, musics, speeches = lazy("noise"), lazy("music"), \
            lazy("speech")
    print("== stage 0: augmentation "
          f"(rirs={bool(rirs)} noise={bool(noises)} "
          f"music={bool(musics)} babble={bool(speeches)})")
    return recipe.augment(data, provider, rirs=rirs, noises=noises,
                          musics=musics, speeches=speeches)


if __name__ == "__main__":
    main()
