"""Interop with the reference's on-disk egs archive format.

Own copy of ``xvector_tpu/data/reference_tar.py`` (numpy only).  The
reference materialises each training archive as a POSIX tar of numpy
files — one ``minibatch_<i>.npy`` float16 tensor of shape (B, T, F) per
minibatch (``examples_io.py:149-178``) — plus a sibling ``<name>.npy``
holding the per-minibatch int32 label vectors
(``create_tar_files.py:130-134``).  Its loader (``examples_io.py:224-255``)
walks the tar in member order and pairs each tensor with the label row
whose index is parsed from the member name.

On write, labels are saved as a plain (num_minibatches, B) int32 array
rather than the reference's dtype=object array of rows: the indexing is
the same, and the reference's own loader (a bare ``np.load``) can read
only the plain form under modern numpy.
"""

from __future__ import annotations

import io
import tarfile
from typing import Iterator, List, Sequence, Tuple

import numpy as np

__all__ = ["write_reference_tar", "read_reference_tar",
           "reference_tar_minibatches"]


def _labels_path(tar_path: str) -> str:
    # the reference derives it by extension swap (examples_io.py:227)
    return tar_path[:-4] + ".npy" if tar_path.endswith(".tar") \
        else tar_path + ".npy"


def write_reference_tar(tar_path: str,
                        minibatches: Sequence[Tuple[np.ndarray, np.ndarray]]):
    """Write [(feats (B, T, F), labels (B,))] as a reference-format archive:
    ``minibatch_<i>.npy`` float16 members plus the sibling labels
    ``.npy``."""
    rows = [np.asarray(y, np.int32) for _, y in minibatches]
    sizes = {r.shape[0] for r in rows}
    if len(sizes) > 1:
        # the plain (N, B) labels layout needs one minibatch size; fail
        # before any tar bytes reach the disk
        raise ValueError(
            f"write_reference_tar needs a uniform minibatch size, got "
            f"{sorted(sizes)}; pad or split the ragged minibatches first")
    labels = np.stack(rows)
    with tarfile.TarFile(tar_path, "w") as tar:
        for i, (feats, _) in enumerate(minibatches):
            buf = io.BytesIO()
            np.save(buf, np.asarray(feats, np.float16))
            info = tarfile.TarInfo(name=f"minibatch_{i}.npy")
            info.size = buf.tell()
            buf.seek(0)
            tar.addfile(tarinfo=info, fileobj=buf)
    np.save(_labels_path(tar_path), labels)


def read_reference_tar(tar_path: str
                       ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (feats float16 (B, T, F), labels (B,) int32) in tar member
    order, pairing each member with the label row indexed by the member
    name (examples_io.py:240-250: ``idx = int(name[:-4].split('_')[1])``).
    ``allow_pickle`` covers labels files written by the reference itself
    (dtype=object rows, create_tar_files.py:133)."""
    labels = np.load(_labels_path(tar_path), allow_pickle=True)
    with tarfile.open(tar_path, "r") as tar:
        for name in tar.getnames():
            idx = int(name[:-4].split("_")[1])
            # BytesIO hop: np.load probes .fileno(), which tarfile's
            # member objects lack
            buf = io.BytesIO(tar.extractfile(name).read())  # type: ignore
            yield np.load(buf), np.asarray(labels[idx], np.int32)


def reference_tar_minibatches(tar_path: str
                              ) -> List[Tuple[np.ndarray, np.ndarray, int]]:
    """Adapt a reference tar to the trainer's minibatch triple contract
    (feats, labels, true_len).  Reference tars carry no mask metadata —
    every frame is real, so true_len is the stored T."""
    return [(mat, lab, int(mat.shape[1]))
            for mat, lab in read_reference_tar(tar_path)]
