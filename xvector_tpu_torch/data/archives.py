"""Training archives (XTA) and their prefetching loader.

Own copy of the file format and loader of ``xvector_tpu/data/archives.py``
(numpy and threading only): an XTA file holds minibatches as contiguous
float16 (B, Tpad, F) tensors, already padded to their bucketed length,
with int32 labels, indexed by a JSON footer (byte offsets, shape, true
length).  Writes are atomic (tmp + rename).  :class:`PrefetchLoader` is
the reference's bounded-queue prefetch thread (``examples_io.py:181-255``)
with its disk-wait accounting.  The plan and materialisation functions are
not ported yet.
"""

from __future__ import annotations

import json
import os
import queue
import struct
import threading
import time
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

__all__ = ["write_archive", "ArchiveReader", "PrefetchLoader"]

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


class PrefetchLoader:
    """Background-thread minibatch prefetcher with wait-time accounting.

    Yields (feats float16 (B, Tpad, F), labels (B,), true_len int), the
    bytes as stored: the host→device upload is half the f32 size and the
    frame mask is built on the device from ``true_len``.  ``disk_wait``
    keeps the reference's load-balance signal (models.py:276-282).
    """

    def __init__(self, reader: ArchiveReader, queue_size: int = 16):
        self._reader = reader
        self._q: queue.Queue = queue.Queue(maxsize=queue_size)
        self._err: list = []
        self.disk_wait = 0.0
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
            t0 = time.monotonic()
            item = self._q.get()
            self.disk_wait += time.monotonic() - t0
            if item is None:
                if self._err:
                    raise self._err[0]
                return
            yield item
