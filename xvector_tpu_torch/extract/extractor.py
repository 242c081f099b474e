"""Batched x-vector extraction with chunk-and-average semantics.

Counterpart of ``xvector_tpu/extract/extractor.py`` (feature input path):

* each utterance is split into consecutive chunks of ≤ ``max_chunk``
  frames; a trailing chunk shorter than ``min_chunk`` is dropped; the
  utterance x-vector is the frame-count-weighted average of its chunks'
  embeddings (the reference protocol);
* chunks are padded to a small set of bucket lengths and batched
  ``batch_size`` at a time per bucket, with a frame mask for the padding;
* :func:`preprocess` applies sliding CMVN and voiced-frame selection.

Output is ready for :class:`xvector_tpu_torch.io.kaldi_ark.ArkWriter`.
The wave-input extractor is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..models import tdnn
from ..models.convert import tree_map
from ..ops import features as F
from ..ops import tdnn_kernel

__all__ = ["ExtractorConfig", "XvectorExtractor", "preprocess",
           "speaker_means"]


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


def preprocess(feats: np.ndarray, cmvn_window: int = 300,
               vad: Optional[np.ndarray] = None,
               device="cuda") -> np.ndarray:
    """Sliding CMVN (on ``device``) then voiced-frame selection (the
    reference's ``apply-cmvn-sliding … | select-voiced-frames`` pipe)."""
    dev = resolve_device(device)
    x = torch.from_numpy(np.array(feats)).to(dev)   # arks give read-only views
    out = F.sliding_cmvn(x, window=cmvn_window).cpu().numpy()
    if vad is not None:
        out = F.select_voiced_frames(out, vad)
    return out


class XvectorExtractor:
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

    def _forward(self, x, mask):
        """(B, T, F) features + (B, T) mask on the device → (B, E) f32."""
        if self.cfg.use_fused:
            h = tdnn_kernel.fused_frame_stack(self.model_cfg, self.params,
                                              self.state, x, mask)
            pooled = tdnn.stats_pooling(h, mask.to(torch.float32)[..., None])
            e0 = self.params["embed"][0]
            f32 = torch.float32
            return (pooled.to(self._cd).to(f32)
                    @ e0["w"].to(self._cd).to(f32)) + e0["b"]
        return tdnn.extract_xvector(self.model_cfg, self.params, self.state,
                                    x, mask=mask, compute_dtype=self._cd)

    def _run(self, x: np.ndarray, mask: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            out = self._forward(torch.from_numpy(x).to(self.device),
                                torch.from_numpy(mask).to(self.device))
            return out.to(torch.float32).cpu().numpy()

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
    def extract_iter(self, stream: Iterable[Tuple[str, np.ndarray]]
                     ) -> Iterator[Tuple[str, np.ndarray]]:
        """Consume (utt, feats (T, F)) pairs; yield (utt, xvector) in
        completion order.  Batches chunks across utterances per length
        bucket; utterances shorter than min_chunk are skipped."""
        feat_dim = self.model_cfg.feat_dim
        pend_sum: Dict[str, np.ndarray] = {}
        pend_weight: Dict[str, float] = {}
        pend_left: Dict[str, int] = {}
        order: List[str] = []
        buckets: Dict[int, List[Tuple[str, np.ndarray, int]]] = {}
        # full (x, mask, items) batches awaiting dispatch, per bucket
        staged: Dict[int, List] = {}

        def credit(items, xv):
            for i, (utt, _, ln) in enumerate(items):
                pend_sum[utt] = pend_sum.get(utt, 0.0) + ln * xv[i]
                pend_weight[utt] = pend_weight.get(utt, 0.0) + ln
                pend_left[utt] -= 1

        def pack(b: int, items):
            n = len(items)
            x = np.zeros((n, b, feat_dim), np.float32)
            mask = np.zeros((n, b), np.float32)
            for i, (_, rows, ln) in enumerate(items):
                x[i, :ln] = rows
                mask[i, :ln] = 1.0
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
            feats = np.asarray(feats, np.float32)
            chunks = self._chunks(feats.shape[0])
            if not chunks:
                continue
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
