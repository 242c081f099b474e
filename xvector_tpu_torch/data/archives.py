"""Training archives (XTA) and their prefetching loader.

Own copy of the file format and loader of ``xvector_tpu/data/archives.py``
(numpy and threading; torch only through the loader's spans): an XTA file
holds minibatches as contiguous float16 (B, Tpad, F) tensors, already
padded to their bucketed length, with int32 labels, indexed by a JSON
footer (byte offsets, shape, true length).  Writes are atomic (tmp +
rename).  :class:`PrefetchLoader` is the reference's bounded-queue
prefetch thread (``examples_io.py:181-255``); the consumer's waits on
it are the span ``xv.data.wait``.

The plan functions turn an :class:`~.allocator.ArchivePlan` into
minibatches: :func:`materialize_archive` (from a ``fetch(utt)`` callable)
and :func:`materialize_archive_native` (libxta's OpenMP ark decode and
float16 gather, ``runtime/native.py``) write an XTA file;
:func:`iter_plan_minibatches` and :func:`stream_plan_loader` yield the
same minibatches straight from the plan with no file on disk.  The same
``shuffle_seed`` gives the same minibatch order on every route.
"""

from __future__ import annotations

import json
import os
import queue
import struct
import threading
from typing import Callable, Dict, Iterator, List, Sequence, Tuple

import numpy as np

from ..utils.profiling import span
from .allocator import ArchivePlan

__all__ = ["write_archive", "ArchiveReader", "PrefetchLoader",
           "materialize_archive", "materialize_archive_native",
           "iter_plan_minibatches", "stream_plan_loader"]

_MAGIC = b"XTA1"


def write_archive(path: str, minibatches: Sequence[Tuple[np.ndarray,
                                                         np.ndarray, int]]):
    """Write [(features (B, Tpad, F) float16, labels (B,) int32,
    true_length)] to an XTA file atomically."""
    tmp = path + ".tmp"
    index: List[Dict] = []
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<q", 0))   # footer offset placeholder
        for feats, labels, true_len in minibatches:
            feats = np.ascontiguousarray(feats, dtype=np.float16)
            labels = np.ascontiguousarray(labels, dtype=np.int32)
            entry = {"offset": f.tell(), "shape": list(feats.shape),
                     "true_length": int(true_len)}
            f.write(feats.tobytes())
            entry["labels_offset"] = f.tell()
            f.write(labels.tobytes())
            index.append(entry)
        footer_at = f.tell()
        f.write(json.dumps({"minibatches": index}).encode())
        f.seek(4)
        f.write(struct.pack("<q", footer_at))
    os.replace(tmp, path)


class ArchiveReader:
    """Random-access reader over an XTA archive."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        magic = self._f.read(4)
        if magic != _MAGIC:
            self._f.close()
            raise ValueError(f"{path}: bad magic {magic!r}")
        (footer_at,) = struct.unpack("<q", self._f.read(8))
        self._f.seek(footer_at)
        self.index = json.loads(self._f.read())["minibatches"]

    def __len__(self) -> int:
        return len(self.index)

    def read(self, i: int) -> Tuple[np.ndarray, np.ndarray, int]:
        e = self.index[i]
        shape = tuple(e["shape"])
        nbytes = int(np.prod(shape)) * 2
        self._f.seek(e["offset"])
        feats = np.frombuffer(self._f.read(nbytes),
                              dtype=np.float16).reshape(shape)
        self._f.seek(e["labels_offset"])
        labels = np.frombuffer(self._f.read(shape[0] * 4), dtype=np.int32)
        return feats, labels, e["true_length"]

    def __iter__(self):
        for i in range(len(self)):
            yield self.read(i)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _assemble_minibatch(mb, rows: Callable[[str], np.ndarray]
                        ) -> Tuple[np.ndarray, np.ndarray, int]:
    """(B, Tpad, F) float16 + labels + true length for one minibatch plan."""
    feat_dim = rows(mb.chunks[0].utt).shape[1]
    x = np.zeros((len(mb.chunks), mb.padded_length, feat_dim),
                 dtype=np.float16)
    y = np.empty(len(mb.chunks), dtype=np.int32)
    for i, c in enumerate(mb.chunks):
        x[i, : c.length] = rows(c.utt)[c.offset: c.offset + c.length]
        y[i] = c.label
    return x, y, mb.length


def _row_cache(fetch: Callable[[str], np.ndarray]):
    """``fetch`` behind a bounded cache: archives visit many utterances
    once and some many times."""
    cache: Dict[str, np.ndarray] = {}

    def rows(utt):
        if utt not in cache:
            if len(cache) > 512:
                cache.clear()
            cache[utt] = np.asarray(fetch(utt), dtype=np.float32)
        return cache[utt]
    return rows


def _order(n: int, shuffle_seed: int | None):
    """Minibatch order on disk: the reference shuffles at load time
    (train_dnn_one_iteration.py:184-188); here with a seeded permutation."""
    if shuffle_seed is None:
        return range(n)
    return np.random.RandomState(shuffle_seed).permutation(n)


def materialize_archive(plan: ArchivePlan, path: str,
                        fetch: Callable[[str], np.ndarray],
                        shuffle_seed: int | None = None):
    """Materialise one archive plan: read each chunk's feature rows via
    ``fetch(utt) -> (T, F)``, pad to the minibatch's bucketed length, store
    float16 in the order ``shuffle_seed`` permutes to.  Skips work if
    ``path`` already exists (idempotent restart)."""
    if os.path.exists(path):
        return
    rows = _row_cache(fetch)
    out = [_assemble_minibatch(mb, rows) for mb in plan.minibatches]
    write_archive(path, [out[i] for i in _order(len(out), shuffle_seed)])


def _native_minibatch(native, mb, utt2src, feat_dim):
    sources = [(utt2src[c.utt][0], utt2src[c.utt][1], c.offset, c.length)
               for c in mb.chunks]
    feats = native.materialize_chunks(sources, mb.padded_length, feat_dim)
    labels = np.fromiter((c.label for c in mb.chunks), np.int32,
                         len(mb.chunks))
    return feats, labels, mb.length


def iter_plan_minibatches(plan: ArchivePlan,
                          fetch: Callable[[str], np.ndarray] | None = None,
                          utt2src: Dict[str, Tuple[str, int]] | None = None,
                          shuffle_seed: int | None = None
                          ) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
    """Assemble minibatches straight from a plan, with no .xta on disk.

    The reference's scp-direct loader path (``examples_io.DataLoader``,
    ``examples_io.py:181-221``, selected over the tar loader at
    ``train_dnn_one_iteration.py:196-203``): chunks are sliced from the
    processed-feature source at iteration time.  ``utt2src`` (utt →
    (ark_path, byte_offset)) routes decoding through libxta when it is
    available; otherwise ``fetch(utt) -> (T, F)`` is used (or, without
    one, the Python ark reader).  ``shuffle_seed`` matches
    :func:`materialize_archive`'s on-disk order exactly, so streaming and
    materialised training see identical minibatch sequences."""
    from ..runtime import native
    use_native = utt2src is not None and native.available()
    if not use_native and fetch is None:
        if utt2src is None:
            raise ValueError("need fetch or utt2src")
        from ..io import kaldi_ark as kio
        fetch = lambda u: kio.read_mat(f"{utt2src[u][0]}:{utt2src[u][1]}")
    rows = None if use_native else _row_cache(fetch)
    feat_dim = None
    if use_native and plan.minibatches:
        feat_dim = native.mat_shape(
            *utt2src[plan.minibatches[0].chunks[0].utt])[1]
    for i in _order(len(plan.minibatches), shuffle_seed):
        mb = plan.minibatches[i]
        if use_native:
            yield _native_minibatch(native, mb, utt2src, feat_dim)
        else:
            yield _assemble_minibatch(mb, rows)


def stream_plan_loader(plan: ArchivePlan,
                       fetch: Callable[[str], np.ndarray] | None = None,
                       utt2src: Dict[str, Tuple[str, int]] | None = None,
                       shuffle_seed: int | None = None,
                       queue_size: int = 16) -> "PrefetchLoader":
    """Prefetching wrapper over :func:`iter_plan_minibatches`, the
    materialisation-free replacement for ``PrefetchLoader(ArchiveReader)``."""
    return PrefetchLoader(iter_plan_minibatches(
        plan, fetch=fetch, utt2src=utt2src, shuffle_seed=shuffle_seed),
        queue_size=queue_size)


def materialize_archive_native(plan: ArchivePlan, path: str,
                               utt2src: Dict[str, Tuple[str, int]],
                               shuffle_seed: int | None = None) -> bool:
    """Materialise via libxta (OpenMP ark decode + float16 gather in C++).

    ``utt2src``: utt → (ark_path, byte_offset) of its *processed* feature
    matrix (the reference reads prepare_feats_for_egs.sh output the same
    way).  Returns False if the native library is unavailable (no
    compiler); callers then fall back to :func:`materialize_archive`.
    """
    from ..runtime import native
    if not native.available():
        return False
    if os.path.exists(path):
        return True
    feat_dim = None
    if plan.minibatches:
        feat_dim = native.mat_shape(
            *utt2src[plan.minibatches[0].chunks[0].utt])[1]
    out = [_native_minibatch(native, mb, utt2src, feat_dim)
           for mb in plan.minibatches]
    write_archive(path, [out[i] for i in _order(len(out), shuffle_seed)])
    return True


class PrefetchLoader:
    """Background-thread minibatch prefetcher.

    Yields (feats float16 (B, Tpad, F), labels (B,), true_len int), the
    bytes as stored: the host→device upload is half the f32 size and the
    frame mask is built on the device from ``true_len``.  Under a profiler
    each wait of the consumer on the queue is the span ``xv.data.wait``,
    the reference's load-balance signal (models.py:276-282).
    """

    def __init__(self, reader: ArchiveReader, queue_size: int = 16):
        self._reader = reader
        self._q: queue.Queue = queue.Queue(maxsize=queue_size)
        self._err: list = []
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self):
        try:
            for feats, labels, true_len in self._reader:
                self._q.put((feats, labels, true_len))
        except Exception as e:  # surface loader errors to the consumer
            self._err.append(e)
        finally:
            self._q.put(None)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
        while True:
            with span("xv.data.wait"):
                item = self._q.get()
            if item is None:
                if self._err:
                    raise self._err[0]
                return
            yield item
