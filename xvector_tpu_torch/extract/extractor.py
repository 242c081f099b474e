"""Batched x-vector extraction with chunk-and-average semantics.

Counterpart of ``xvector_tpu/extract/extractor.py``:

* feature input (:class:`XvectorExtractor`): each utterance is split into
  consecutive chunks of ≤ ``max_chunk`` frames; a trailing chunk shorter
  than ``min_chunk`` is dropped; the utterance x-vector is the
  frame-count-weighted average of its chunks' embeddings (the reference
  protocol); chunks are padded to a small set of bucket lengths and
  batched ``batch_size`` at a time per bucket, with a frame mask for the
  padding; :func:`preprocess` applies sliding CMVN and voiced-frame
  selection in one call and leaves the rows on the device, where
  ``extract_iter`` chunks, pads and runs them without a copy back;
  ``XvectorExtractor.counters`` keeps running totals of the utterances,
  chunks, batches, real and padded frames it ran and the utterances it had
  to upload;
* wave input (:class:`WaveExtractor`, :func:`make_wave_to_xvector`):
  padded batches of waveforms go through MFCC, energy VAD, sliding CMVN,
  voiced-frame compaction, the frame stack (K1 with ``use_fused``),
  pooling and the embedding on the device, one batch per length bucket;
  :func:`read_wav_scp` streams a Kaldi wav.scp.

Output is ready for :class:`xvector_tpu_torch.io.kaldi_ark.ArkWriter`.
Under a profiler the feature path's layers are ``xv.extract.*`` spans:
``preprocess`` (its ``cmvn``: staging, upload and the CMVN-and-selection
launch), ``upload`` (an utterance that ``extract_iter`` was given on the
host), ``pack`` and ``run`` (its ``frame_stack``, ``pooling``,
``embedding`` and ``download``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..io import wav as wavlib
from ..models import tdnn
from ..models.convert import tree_map
from ..ops import features as F
from ..ops import tdnn_kernel
from ..utils.profiling import span, tracing

__all__ = ["ExtractorConfig", "XvectorExtractor", "preprocess",
           "speaker_means", "make_wave_to_xvector", "WaveExtractor",
           "WaveExtractorConfig", "read_wav_scp", "pack_wave_batch"]


@dataclass(frozen=True)
class ExtractorConfig:
    min_chunk: int = 25        # run_xvector.sh:75
    max_chunk: int = 10000     # run_xvector.sh:70
    batch_size: int = 32
    # bucket boundaries: pad each chunk up to the next bucket; geometric-ish
    # spacing bounds padding waste at ~2x worst case
    buckets: Tuple[int, ...] = (32, 64, 128, 192, 256, 384, 512, 768, 1024,
                                1536, 2048, 3072, 4096, 6144, 8192, 10016)
    # f32 keeps exact CPU-reference parity in tests; serving passes bfloat16
    compute_dtype: str = "float32"
    # full batches of one bucket staged before they run, one after another
    dispatch_depth: int = 1
    # frame stack through the hand-written kernel (ops/tdnn_kernel.py)
    use_fused: bool = False


def _xvector(model_cfg, params, state, x, mask, compute_dtype, fused,
             folded=None):
    """(B, T, F) features + (B, T) mask → (B, E) f32 x-vectors: the frame
    stack through K1 (``fused``: stats pooling and the embedding after it
    in ``compute_dtype`` operands; ``folded``, the parameters'
    ``tdnn_kernel.fold_stack``, or None to fold them here) or through
    ``tdnn.extract_xvector``."""
    if not fused:
        with span("xv.extract.frame_stack"):
            return tdnn.extract_xvector(model_cfg, params, state, x,
                                        mask=mask, compute_dtype=compute_dtype)
    with span("xv.extract.frame_stack"):
        h = tdnn_kernel.fused_frame_stack(
            model_cfg, params if folded is None else folded, state, x, mask)
    with span("xv.extract.pooling"):
        pooled = tdnn.stats_pooling(h, mask.to(torch.float32)[..., None])
    with span("xv.extract.embedding"):
        e0 = params["embed"][0]
        f32 = torch.float32
        return (pooled.to(compute_dtype).to(f32)
                @ e0["w"].to(compute_dtype).to(f32)) + e0["b"]


def _upload(dev: torch.device, *arrays) -> List[torch.Tensor]:
    """Host arrays → tensors on ``dev`` (float32, or int32 for integer
    arrays): each written once into one page-locked block of torch's
    caching host allocator, which goes up in one copy that does not wait
    on the card (the allocator keeps the block until the copy has run); on
    the CPU written into one fresh tensor.  An array may be a read-only
    view, such as an ark's."""
    arrays = [np.asarray(a) for a in arrays]
    sizes = [a.size for a in arrays]
    buf = torch.empty(sum(sizes), dtype=torch.int32,
                      pin_memory=dev.type == "cuda")
    host, at = buf.numpy(), 0
    for a, n in zip(arrays, sizes):
        kind = np.int32 if np.issubdtype(a.dtype, np.integer) else np.float32
        host[at:at + n].view(kind).reshape(a.shape)[...] = a
        at += n
    buf = buf.to(dev, non_blocking=True)
    out, at = [], 0
    for a, n in zip(arrays, sizes):
        part = buf[at:at + n]
        if not np.issubdtype(a.dtype, np.integer):
            part = part.view(torch.float32)
        out.append(part.view(a.shape))
        at += n
    return out


def preprocess(feats, cmvn_window: int = 300,
               vad: Optional[np.ndarray] = None,
               device="cuda") -> torch.Tensor:
    """Sliding CMVN then voiced-frame selection (the reference's
    ``apply-cmvn-sliding … | select-voiced-frames`` pipe) in one call of
    :func:`features.sliding_cmvn` with the VAD's destination map: on the
    card one kernel launch.  Returns the voiced rows as an f32 (rows, D)
    tensor on ``device`` without waiting for it.

    ``feats`` (T, D) is a host array, which goes up once with the map
    (:func:`_upload`), or a tensor, used in place on ``device``; ``vad``
    (T,) is a host array: the map and its row count come from it on the
    host."""
    dev = resolve_device(device)
    with span("xv.extract.preprocess"), span("xv.extract.cmvn"):
        dest, rows = (None, None) if vad is None else F.voiced_map(vad)
        if isinstance(feats, torch.Tensor):
            x = feats.to(dev)
            if dest is not None:
                [dest] = _upload(dev, dest)
        elif dest is None:
            [x] = _upload(dev, feats)
        else:
            x, dest = _upload(dev, feats, dest)
        return F.sliding_cmvn(x, window=cmvn_window, dest=dest,
                              rows=rows).to(torch.float32)


class XvectorExtractor:
    """Feature → x-vector extraction on ``device``.  The weights are moved
    there once (tensors already on it are the caller's, not copies) and,
    with ``use_fused``, folded for K1 once, here: weights changed after
    construction are not seen by the fused stack.  ``counters`` holds
    running totals over every call: ``utterances`` (those with a chunk),
    ``chunks``, ``batches``, ``frames_real`` (chunk frames),
    ``frames_padded`` (the batches' rows times their bucket length) and
    ``host_inputs`` (utterances given as host arrays or on another device,
    which ``extract_iter`` uploads; :func:`preprocess`'s rows are not)."""

    def __init__(self, model_cfg: tdnn.TdnnConfig, params, state,
                 cfg: ExtractorConfig = ExtractorConfig(), device="cuda"):
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.state = tree_map(lambda t: t.to(self.device), state)
        self.cfg = cfg
        self._cd = getattr(torch, cfg.compute_dtype)
        if cfg.use_fused and not tdnn_kernel.supports(model_cfg):
            raise ValueError("fused extraction unsupported for "
                             f"topology {model_cfg.name}")
        self.folded = (tdnn_kernel.fold_stack(model_cfg, self.params,
                                              self.state)
                       if cfg.use_fused else None)
        self.counters = {"utterances": 0, "chunks": 0, "batches": 0,
                         "frames_real": 0, "frames_padded": 0,
                         "host_inputs": 0}

    def _forward(self, x, mask):
        """(B, T, F) features + (B, T) mask on the device → (B, E) f32."""
        return _xvector(self.model_cfg, self.params, self.state, x, mask,
                        self._cd, self.cfg.use_fused, self.folded)

    def _run(self, x: torch.Tensor, mask: torch.Tensor) -> np.ndarray:
        """A packed batch on the device → its (B, E) x-vectors on the host:
        the one wait on the card a batch."""
        args = f"bucket={x.shape[1]} rows={x.shape[0]}" if tracing() else None
        with span("xv.extract.run", args), torch.inference_mode():
            out = self._forward(x, mask)
            with span("xv.extract.download"):
                return out.to(torch.float32).cpu().numpy()

    def _rows(self, feats) -> torch.Tensor:
        """An utterance's (T, F) features as an f32 tensor on the device:
        a tensor there as it is, anything else uploaded once."""
        dev = self.device
        if isinstance(feats, torch.Tensor):
            # a device without an index takes a tensor on any of its kind
            if feats.device.type == dev.type and dev.index in (
                    None, feats.device.index):
                return feats.to(torch.float32)
            feats = feats.detach().to("cpu", torch.float32).numpy()
        self.counters["host_inputs"] += 1
        with span("xv.extract.upload"):
            [x] = _upload(dev, feats)
        return x

    # -- chunking ---------------------------------------------------------
    def _chunks(self, num_rows: int) -> List[Tuple[int, int]]:
        """(offset, length) chunk list per the reference protocol:
        ceil(rows/max_chunk) consecutive chunks, drop short tail."""
        c = self.cfg
        if num_rows <= c.max_chunk:
            return [(0, num_rows)] if num_rows >= c.min_chunk else []
        out = []
        for off in range(0, num_rows, c.max_chunk):
            ln = min(c.max_chunk, num_rows - off)
            if ln >= c.min_chunk:
                out.append((off, ln))
        return out

    def _bucket(self, length: int) -> int:
        for b in self.cfg.buckets:
            if length <= b:
                return b
        return self.cfg.buckets[-1]

    # -- batched streaming extraction -------------------------------------
    def extract_iter(self, stream: Iterable[Tuple[str, object]]
                     ) -> Iterator[Tuple[str, np.ndarray]]:
        """Consume (utt, feats (T, F)) pairs; yield (utt, xvector) in
        completion order.  Batches chunks across utterances per length
        bucket; utterances shorter than min_chunk are skipped.  Features
        on the device (:func:`preprocess`'s) are chunked as views and
        padded into batches there; host arrays go up once an utterance
        (``counters["host_inputs"]``)."""
        feat_dim = self.model_cfg.feat_dim
        dev = self.device
        counts = self.counters
        pend_sum: Dict[str, np.ndarray] = {}
        pend_weight: Dict[str, float] = {}
        pend_left: Dict[str, int] = {}
        order: List[str] = []
        buckets: Dict[int, List[Tuple[str, torch.Tensor, int]]] = {}
        # full (x, mask, items) batches awaiting dispatch, per bucket
        staged: Dict[int, List] = {}

        def credit(items, xv):
            for i, (utt, _, ln) in enumerate(items):
                pend_sum[utt] = pend_sum.get(utt, 0.0) + ln * xv[i]
                pend_weight[utt] = pend_weight.get(utt, 0.0) + ln
                pend_left[utt] -= 1

        def pack(b: int, items):
            """The zero-padded (n, b, F) f32 batch and its (n, b) mask, on
            the device: one copy a chunk, the mask from the lengths."""
            with span("xv.extract.pack"):
                n = len(items)
                x = torch.zeros((n, b, feat_dim), dtype=torch.float32,
                                device=dev)
                for i, (_, rows, ln) in enumerate(items):
                    x[i, :ln] = rows
                [lens] = _upload(dev, np.array([ln for *_, ln in items],
                                               np.int32))
                mask = (torch.arange(b, device=dev)[None]
                        < lens[:, None]).to(torch.float32)
                counts["batches"] += 1
                counts["frames_padded"] += n * b
                return x, mask

        def dispatch_staged(b: int):
            for x, mask, items in staged.pop(b, []):
                credit(items, self._run(x, mask))

        def run_bucket(b: int, final: bool = False):
            items = buckets.pop(b, [])
            if items:
                x, mask = pack(b, items)
                if not final and len(items) >= self.cfg.batch_size:
                    staged.setdefault(b, []).append((x, mask, items))
                    if len(staged[b]) >= self.cfg.dispatch_depth:
                        dispatch_staged(b)
                    return
                credit(items, self._run(x, mask))
            if final:
                dispatch_staged(b)

        def drain_complete():
            while order and pend_left.get(order[0], 1) == 0:
                utt = order.pop(0)
                del pend_left[utt]
                yield utt, (pend_sum.pop(utt)
                            / pend_weight.pop(utt)).astype(np.float32)

        for utt, feats in stream:
            chunks = self._chunks(len(feats))
            if not chunks:
                continue
            feats = self._rows(feats)
            counts["utterances"] += 1
            counts["chunks"] += len(chunks)
            counts["frames_real"] += sum(ln for _, ln in chunks)
            order.append(utt)
            pend_left[utt] = len(chunks)
            for off, ln in chunks:
                b = self._bucket(ln)
                buckets.setdefault(b, []).append(
                    (utt, feats[off: off + ln], ln))
                if len(buckets[b]) >= self.cfg.batch_size:
                    run_bucket(b)
                    yield from drain_complete()
        for b in sorted(set(buckets) | set(staged)):
            run_bucket(b, final=True)
        yield from drain_complete()

    def extract(self, stream: Iterable[Tuple[str, np.ndarray]]
                ) -> Dict[str, np.ndarray]:
        return dict(self.extract_iter(stream))


def pack_wave_batch(items, bucket_len: int, n_rows: int):
    """Zero-pad (utt, wave) items into an int16 (n_rows, bucket_len) batch
    + per-row sample counts: the one place that fixes the quantisation
    (rint + clip, exactly a 16-bit wav write) and the int16 upload format
    (half the bytes of f32)."""
    waves = np.zeros((n_rows, bucket_len), np.int16)
    lens = np.zeros(n_rows, np.int32)
    for i, (_, w) in enumerate(items):
        waves[i, : len(w)] = np.clip(np.rint(w), -32768, 32767)
        lens[i] = len(w)
    return waves, lens


@dataclass(frozen=True)
class WaveExtractorConfig:
    """Config for :class:`WaveExtractor` (``--wav-rspecifier``)."""
    min_chunk: int = 25        # run_xvector.sh:75 (voiced frames)
    max_chunk: int = 10000     # run_xvector.sh:70 (frames = 100 s @ 8 kHz)
    batch_size: int = 16
    cmvn_window: int = 300
    dither_seed: int = 0       # 0 disables dither (deterministic extract)
    compute_dtype: str = "bfloat16"
    # waveform-length buckets in seconds; a batch holds one bucket
    bucket_seconds: Tuple[float, ...] = (
        1, 2, 3, 5, 8, 12, 20, 30, 45, 60, 80, 100)
    # frame stack through the hand-written kernel (as ExtractorConfig's)
    use_fused: bool = False


def make_wave_to_xvector(model_cfg: tdnn.TdnnConfig,
                         mfcc_cfg: F.MfccConfig = F.MfccConfig(),
                         vad_cfg: F.VadConfig = F.VadConfig(),
                         cmvn_window: int = 300,
                         compute_dtype=torch.bfloat16,
                         use_fused: bool = False, device="cuda"):
    """Waveform batch → x-vectors on ``device``: dithered MFCC, energy
    VAD, sliding CMVN, voiced-frame compaction, the frame stack (K1 with
    ``use_fused``, else ``tdnn.extract_xvector``), pooling and the
    embedding, over a padded ``(B, S)`` batch; the reference needs four
    Kaldi binaries per utterance plus a TF forward for the same chain
    (``run.sh:97-101``, ``extract_xvectors.sh:68``, ``models.py:356-432``).

    Returns ``fn(params, state, waves, n_samples, generator=None) ->
    (xvectors (B, D) f32, voiced_frames (B,) int32)`` on the device;
    params and state must be on it.  ``voiced_frames`` lets the caller
    apply the recipe's min-chunk policy (``run_xvector.sh:75``); rows with
    no voiced frame come back NaN, so an all-silence utterance cannot pass
    for an embedding.  Utterances longer than ``max_chunk`` frames are
    the caller's to split, as :class:`WaveExtractor` does.  With
    ``use_fused`` the weights are folded for K1 once per (params, state)
    pair ``fn`` is given: change them in place and the fold is stale."""
    dev = resolve_device(device)
    if use_fused and not tdnn_kernel.supports(model_cfg):
        raise ValueError("fused extraction unsupported for topology "
                         f"{model_cfg.name}")
    fold = {"params": None, "state": None, "stack": None}

    def fn(params, state, waves, n_samples, generator=None):
        if use_fused and (fold["params"] is not params
                          or fold["state"] is not state):
            fold.update(params=params, state=state, stack=(
                tdnn_kernel.fold_stack(model_cfg, params, state)))
        with torch.inference_mode():
            feats, fmask = F.mfcc_batch(torch.as_tensor(waves).to(dev),
                                        torch.as_tensor(n_samples).to(dev),
                                        mfcc_cfg, generator)
            vad = F.energy_vad_batch(feats, fmask, vad_cfg)
            feats = F.sliding_cmvn_batch(feats, fmask, window=cmvn_window)
            feats, vmask = F.compact_voiced(feats, vad)
            xv = _xvector(model_cfg, params, state, feats, vmask,
                          compute_dtype, use_fused, fold["stack"])
            voiced = vmask.sum(1).to(torch.int32)
            return torch.where((voiced > 0)[:, None], xv, torch.nan), voiced

    return fn


class WaveExtractor:
    """Wave → x-vector extraction: batches raw waveforms by length bucket
    through :func:`make_wave_to_xvector` on the device.

    Utterances longer than ``max_chunk`` frames take a two-stage path:
    ``mfcc`` → ``energy_vad`` → :func:`preprocess` over the whole
    utterance, then the feature extractor's chunk-and-average protocol
    (with the same ``use_fused``): the reference runs CMVN and VAD over
    the full utterance before chunking (models.py:396-421).  Dither draws
    from one ``torch.Generator`` on the device, seeded from
    ``cfg.dither_seed`` (0 turns dither off)."""

    def __init__(self, model_cfg: tdnn.TdnnConfig, params, state,
                 cfg: WaveExtractorConfig = WaveExtractorConfig(),
                 mfcc_cfg: F.MfccConfig = F.MfccConfig(),
                 vad_cfg: F.VadConfig = F.VadConfig(), device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        if cfg.dither_seed == 0:
            mfcc_cfg = replace(mfcc_cfg, dither=0.0)
        self.mfcc_cfg = mfcc_cfg
        self.vad_cfg = vad_cfg
        # feature-path extractor for > max_chunk utterances; it also moves
        # the weights to the device once for both paths
        self._long = XvectorExtractor(
            model_cfg, params, state,
            ExtractorConfig(min_chunk=cfg.min_chunk,
                            max_chunk=cfg.max_chunk,
                            batch_size=max(1, cfg.batch_size // 4),
                            compute_dtype=cfg.compute_dtype,
                            use_fused=cfg.use_fused),
            device=self.device)
        self.params, self.state = self._long.params, self._long.state
        self._fn = make_wave_to_xvector(
            model_cfg, mfcc_cfg, vad_cfg, cmvn_window=cfg.cmvn_window,
            compute_dtype=getattr(torch, cfg.compute_dtype),
            use_fused=cfg.use_fused, device=self.device)
        self._gen = (torch.Generator(device=self.device).manual_seed(
            cfg.dither_seed) if cfg.dither_seed else None)
        sr = mfcc_cfg.sample_rate
        self._buckets = tuple(int(s * sr) for s in cfg.bucket_seconds)
        # sample count beyond which the utterance exceeds max_chunk frames
        self._long_samples = cfg.max_chunk * mfcc_cfg.frame_shift

    def _bucket(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return self._buckets[-1]

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """Host array → device; from pinned memory without waiting on the
        card, so the copy queues behind the previous batch's work."""
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def extract_iter(self, stream: Iterable[Tuple[str, np.ndarray]]
                     ) -> Iterator[Tuple[str, np.ndarray]]:
        """Consume (utt, wave float32 int16-scale) pairs; yield (utt,
        xvector).  Utterances with < min_chunk voiced frames are skipped
        (the reference logs and skips, models.py:405-407).  A batch runs at
        its true size; its results stay on the device until two later
        batches are queued, so the host does not wait on each one."""
        buckets: Dict[int, List[Tuple[str, np.ndarray]]] = {}
        inflight: List[Tuple[List, torch.Tensor, torch.Tensor]] = []

        def materialize(entry):
            items, xv_dev, voiced_dev = entry
            xv, voiced = xv_dev.cpu().numpy(), voiced_dev.cpu().numpy()
            for i, (utt, _) in enumerate(items):
                if voiced[i] >= self.cfg.min_chunk:
                    yield utt, xv[i].astype(np.float32)

        def run_bucket(b: int):
            items = buckets.pop(b, [])
            if not items:
                return
            waves, lens = pack_wave_batch(items, b, len(items))
            xv, voiced = self._fn(self.params, self.state,
                                  self._upload(waves), self._upload(lens),
                                  self._gen)
            inflight.append((items, xv, voiced))
            while len(inflight) > 2:
                yield from materialize(inflight.pop(0))

        def long_path(utt, wave):
            w = torch.from_numpy(wave).to(self.device)
            feats = F.mfcc(w, self.mfcc_cfg, self._gen)
            vad = F.energy_vad(feats, self.vad_cfg)
            feats = preprocess(feats, cmvn_window=self.cfg.cmvn_window,
                               vad=vad.cpu().numpy(), device=self.device)
            yield from self._long.extract_iter([(utt, feats)])

        for utt, wave in stream:
            wave = np.asarray(wave, np.float32).reshape(-1)
            if len(wave) > self._long_samples:
                yield from long_path(utt, wave)
                continue
            b = self._bucket(len(wave))
            buckets.setdefault(b, []).append((utt, wave))
            if len(buckets[b]) >= self.cfg.batch_size:
                yield from run_bucket(b)
        for b in sorted(buckets):
            yield from run_bucket(b)
        while inflight:
            yield from materialize(inflight.pop(0))

    def extract(self, stream) -> Dict[str, np.ndarray]:
        return dict(self.extract_iter(stream))


def read_wav_scp(path: str, target_sr: Optional[int] = 8000
                 ) -> Iterator[Tuple[str, np.ndarray]]:
    """Stream (utt, wave) pairs from a Kaldi wav.scp (plain paths,
    ``path#chN`` channel specs, embedded-shorten SPHERE included, or
    ``cmd |`` pipes).

    ``target_sr``: entries stored at another rate are resampled
    (band-limited polyphase) to the front end's rate; None forwards the
    samples as stored."""
    with open(path) as f:
        for line in f:
            parts = line.strip().split(None, 1)
            if len(parts) != 2:
                continue
            utt, spec = parts
            samples, rate = wavlib.load_wave(spec)
            if target_sr and rate and rate != target_sr:
                samples = wavlib.resample(samples, rate, target_sr)
            yield utt, samples


def speaker_means(xvectors: Dict[str, np.ndarray],
                  utt2spk: Dict[str, str]
                  ) -> Tuple[Dict[str, np.ndarray], Dict[str, int]]:
    """Per-speaker mean x-vectors + utterance counts (``ivector-mean``
    spk2utt path)."""
    sums: Dict[str, np.ndarray] = {}
    counts: Dict[str, int] = {}
    for utt, v in xvectors.items():
        spk = utt2spk[utt]
        sums[spk] = sums.get(spk, 0.0) + v
        counts[spk] = counts.get(spk, 0) + 1
    return {s: (sums[s] / counts[s]).astype(np.float32)
            for s in sums}, counts
