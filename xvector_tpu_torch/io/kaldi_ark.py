"""Kaldi ark/scp binary interchange for the extraction path.

Own copy of what extraction needs from ``xvector_tpu/io/kaldi_ark.py``
(the port imports nothing of that package): rspecifier parsing with pipe
support, float matrices (including compressed CM/CM2/CM3 reads), float
vectors, and the ark+scp writer.  The native libxta readers and the
compressed-matrix writer are not ported yet.

Format notes
------------
* A binary table entry is ``<key> <0x00>B<payload>``.
* Float matrix payload: ``FM `` + (int32 rows, int32 cols each preceded by a
  size byte ``\\x04``) + row-major float32 data.  ``DM `` is the float64 twin.
* Float vector payload: ``FV ``/``DV `` + int32 dim + data.
* Compressed matrix ``CM `` (format 1): global header (min, range float32;
  rows, cols int32), then per-column {0,25,75,100}-percentile uint16 headers,
  then per-column uint8 codes, column-major.  ``CM2`` (format 2) is a flat
  uint16 encoding; ``CM3`` (format 3) is per-row uint8.
* An scp line is ``<key> <path>:<byte-offset>`` pointing at the ``\\x00B``.
"""

from __future__ import annotations

import gzip
import io as _io
import os
import struct
import subprocess
import sys
from typing import BinaryIO, Iterator, Tuple

import numpy as np

__all__ = ["open_or_fd", "read_mat", "read_mat_ark", "read_mat_scp",
           "write_mat", "read_vec_flt", "read_vec_flt_ark",
           "read_vec_flt_scp", "write_vec_flt", "ArkWriter"]


# ---------------------------------------------------------------------------
# File / pipe plumbing
# ---------------------------------------------------------------------------

class _PipeHandle:
    """File-like wrapper that reaps its subprocess on close."""

    def __init__(self, proc: subprocess.Popen, stream: BinaryIO):
        self._proc = proc
        self._stream = stream

    def __getattr__(self, name):
        return getattr(self._stream, name)

    def close(self):
        self._stream.close()
        rc = self._proc.wait()
        if rc != 0:
            raise IOError(f"pipe subprocess exited with status {rc}")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


_SPEC_OPTS = ("ark", "scp", "t", "b", "p", "o", "s", "cs", "f", "n")


def open_or_fd(file_or_fd, mode: str = "rb"):
    """Open a filename / 'cmd |' read-pipe / '| cmd' write-pipe / '-' / fd.

    Strips a leading ``ark:``/``scp:`` (with optional ``o,``/``s,``/``cs,``
    etc. option prefixes) and a trailing ``:<offset>`` (seeking to it).
    """
    if not isinstance(file_or_fd, str):
        return file_or_fd
    spec = file_or_fd
    offset = None
    head, sep, tail = spec.partition(":")
    if sep and all(tok in _SPEC_OPTS for tok in head.split(",")):
        spec = tail
    if ":" in spec and not spec.endswith("|") and not spec.startswith("|"):
        base, _, off = spec.rpartition(":")
        if off.isdigit() and (os.path.exists(base) or not os.path.exists(spec)):
            spec, offset = base, int(off)

    if spec == "-":
        return sys.stdin.buffer if "r" in mode else sys.stdout.buffer
    if spec.endswith("|"):
        proc = subprocess.Popen(spec[:-1].strip(), shell=True,
                                stdout=subprocess.PIPE)
        return _PipeHandle(proc, proc.stdout)
    if spec.startswith("|"):
        proc = subprocess.Popen(spec[1:].strip(), shell=True,
                                stdin=subprocess.PIPE)
        return _PipeHandle(proc, proc.stdin)
    if spec.endswith(".gz") and "r" in mode:
        fd = gzip.open(spec, mode if mode.endswith("b") else mode + "b")
    else:
        fd = open(spec, mode if mode.endswith("b") else mode + "b")
    if offset is not None:
        fd.seek(offset)
    return fd


def _maybe_close(fd, file_or_fd):
    if isinstance(file_or_fd, str):
        fd.close()


# ---------------------------------------------------------------------------
# Low-level token / int readers
# ---------------------------------------------------------------------------

_WS = b" \t\n"


def _read_key(fd) -> str | None:
    """Read a whitespace-terminated table key; None at EOF.  Scans the
    stream's buffer via ``peek()`` where the stream has it, so a key costs
    a few bulk reads instead of one ``read(1)`` per byte."""
    peek = getattr(fd, "peek", None)
    if peek is None:
        return _read_key_bytewise(fd)
    while True:
        buf = peek(1)
        if not buf:
            return None
        i = 0
        while i < len(buf) and buf[i] in _WS:
            i += 1
        if i:
            fd.read(i)
        if i < len(buf):
            break
    key = bytearray()
    while True:
        buf = peek(1)
        if not buf:
            return key.decode("latin1") if key else None
        end = min((j for j in (buf.find(d) for d in (b" ", b"\t", b"\n"))
                   if j != -1), default=-1)
        if end == -1:
            key += fd.read(len(buf))
        else:
            key += fd.read(end)
            fd.read(1)
            return key.decode("latin1")


def _read_key_bytewise(fd) -> str | None:
    chars = []
    while True:
        c = fd.read(1)
        if c == b"":
            return None if not chars else "".join(chars)
        if c in (b" ", b"\t", b"\n"):
            if chars:
                return "".join(chars)
            continue
        chars.append(c.decode("latin1"))


def _read_basic_int32(fd) -> int:
    size = fd.read(1)
    if size != b"\x04":
        raise ValueError(f"expected int32 size byte, got {size!r}")
    return struct.unpack("<i", fd.read(4))[0]


def _write_basic_int32(fd, value: int):
    fd.write(b"\x04" + struct.pack("<i", value))


def _expect_binary_entry(fd, key: str):
    marker = fd.read(2)
    if marker != b"\x00B":
        raise ValueError(f"ark entry {key}: not binary ({marker!r})")


# ---------------------------------------------------------------------------
# Matrices
# ---------------------------------------------------------------------------

def read_mat(file_or_fd) -> np.ndarray:
    """Read one matrix (binary or text) from a file/fd/rspecifier target."""
    fd = open_or_fd(file_or_fd)
    try:
        binary = fd.read(2)
        if binary == b"\x00B":
            return _read_mat_binary(fd)
        rest = binary + fd.read()
        return _parse_ascii_mat(rest.decode("utf-8"))
    finally:
        _maybe_close(fd, file_or_fd)


def _parse_ascii_mat(text: str) -> np.ndarray:
    text = text.strip()
    if text.startswith("["):
        text = text[1:]
    if text.endswith("]"):
        text = text[:-1]
    rows = [r.split() for r in text.strip().splitlines() if r.split()]
    return np.array(rows, dtype=np.float32)


def _read_mat_binary(fd) -> np.ndarray:
    header = fd.read(3)
    if header == b"FM ":
        dtype, itemsize = np.float32, 4
    elif header == b"DM ":
        dtype, itemsize = np.float64, 8
    elif header in (b"CM ", b"CM2", b"CM3"):
        return _read_compressed_mat(fd, header)
    else:
        raise ValueError(f"unknown matrix header {header!r}")
    rows = _read_basic_int32(fd)
    cols = _read_basic_int32(fd)
    buf = fd.read(rows * cols * itemsize)
    mat = np.frombuffer(buf, dtype=dtype).reshape(rows, cols)
    return mat.astype(np.float32, copy=False)


def _uint16_to_float(u: np.ndarray, gmin: float, grange: float) -> np.ndarray:
    return gmin + grange * (u.astype(np.float64) * (1.0 / 65535.0))


def _read_compressed_mat(fd, fmt: bytes) -> np.ndarray:
    """Decode Kaldi CompressedMatrix formats 1 (CM), 2 (CM2), 3 (CM3)."""
    gmin, grange, rows, cols = struct.unpack("<ffii", fd.read(16))
    if fmt == b"CM2":
        buf = fd.read(rows * cols * 2)
        codes = np.frombuffer(buf, dtype="<u2").reshape(rows, cols)
        return _uint16_to_float(codes, gmin, grange).astype(np.float32)
    if fmt == b"CM3":
        buf = fd.read(rows * cols)
        codes = np.frombuffer(buf, dtype=np.uint8).reshape(rows, cols)
        return (gmin + grange * codes.astype(np.float64) / 255.0).astype(
            np.float32)
    # CM (format 1): per-column percentile headers + uint8 codes, col-major
    hdr = np.frombuffer(fd.read(cols * 8), dtype="<u2").reshape(cols, 4)
    p0, p25, p75, p100 = (
        _uint16_to_float(hdr[:, i], gmin, grange) for i in range(4))
    codes = np.frombuffer(fd.read(cols * rows), dtype=np.uint8).reshape(
        cols, rows).astype(np.float64)
    # piecewise-linear decode per Kaldi CompressedMatrix::CharToFloat
    lo = codes <= 64
    hi = codes > 192
    mid = ~lo & ~hi
    c0, c25, c75, c100 = (x[:, None] for x in (p0, p25, p75, p100))
    out = np.where(lo, c0 + (c25 - c0) * (codes / 64.0),
                   np.where(mid, c25 + (c75 - c25) * ((codes - 64.0) / 128.0),
                            c75 + (c100 - c75) * ((codes - 192.0) / 63.0)))
    return out.T.astype(np.float32)


def write_mat(file_or_fd, mat: np.ndarray, key: str = ""):
    """Write one float32/float64 matrix in Kaldi binary format."""
    fd = open_or_fd(file_or_fd, mode="wb")
    try:
        if key:
            fd.write((key + " ").encode("latin1"))
        fd.write(b"\x00B")
        if mat.dtype == np.float64:
            fd.write(b"DM ")
            data = mat.astype("<f8", copy=False)
        else:
            fd.write(b"FM ")
            data = mat.astype("<f4", copy=False)
        _write_basic_int32(fd, mat.shape[0])
        _write_basic_int32(fd, mat.shape[1])
        fd.write(np.ascontiguousarray(data).tobytes())
    finally:
        _maybe_close(fd, file_or_fd)


def read_mat_ark(file_or_fd) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield (key, matrix) over a binary ark stream."""
    fd = open_or_fd(file_or_fd)
    try:
        while True:
            key = _read_key(fd)
            if key is None:
                return
            _expect_binary_entry(fd, key)
            yield key, _read_mat_binary(fd)
    finally:
        _maybe_close(fd, file_or_fd)


def read_mat_scp(file_or_fd) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield (key, matrix) over an scp file of ark offsets."""
    fd = open_or_fd(file_or_fd)
    try:
        for line in fd:
            key, _, rxfile = line.decode("utf-8").strip().partition(" ")
            if not key:
                continue
            yield key, read_mat(rxfile)
    finally:
        _maybe_close(fd, file_or_fd)


# ---------------------------------------------------------------------------
# Float vectors
# ---------------------------------------------------------------------------

def read_vec_flt(file_or_fd) -> np.ndarray:
    fd = open_or_fd(file_or_fd)
    try:
        binary = fd.read(2)
        if binary == b"\x00B":
            return _read_vec_flt_binary(fd)
        rest = (binary + fd.read()).decode("utf-8").strip()
        if rest.startswith("["):
            rest = rest[1:]
        if rest.endswith("]"):
            rest = rest[:-1]
        return np.array(rest.split(), dtype=np.float32)
    finally:
        _maybe_close(fd, file_or_fd)


def _read_vec_flt_binary(fd) -> np.ndarray:
    header = fd.read(3)
    if header == b"FV ":
        dtype, itemsize = "<f4", 4
    elif header == b"DV ":
        dtype, itemsize = "<f8", 8
    else:
        raise ValueError(f"unknown vector header {header!r}")
    dim = _read_basic_int32(fd)
    return np.frombuffer(fd.read(dim * itemsize), dtype=dtype).astype(
        np.float32, copy=False)


def write_vec_flt(file_or_fd, vec: np.ndarray, key: str = ""):
    fd = open_or_fd(file_or_fd, mode="wb")
    try:
        if key:
            fd.write((key + " ").encode("latin1"))
        fd.write(b"\x00B")
        if vec.dtype == np.float64:
            fd.write(b"DV ")
            data = vec.astype("<f8", copy=False)
        else:
            fd.write(b"FV ")
            data = vec.astype("<f4", copy=False)
        _write_basic_int32(fd, vec.shape[0])
        fd.write(np.ascontiguousarray(data).tobytes())
    finally:
        _maybe_close(fd, file_or_fd)


def read_vec_flt_ark(file_or_fd) -> Iterator[Tuple[str, np.ndarray]]:
    fd = open_or_fd(file_or_fd)
    try:
        while True:
            key = _read_key(fd)
            if key is None:
                return
            _expect_binary_entry(fd, key)
            yield key, _read_vec_flt_binary(fd)
    finally:
        _maybe_close(fd, file_or_fd)


def read_vec_flt_scp(file_or_fd) -> Iterator[Tuple[str, np.ndarray]]:
    fd = open_or_fd(file_or_fd)
    try:
        for line in fd:
            key, _, rxfile = line.decode("utf-8").strip().partition(" ")
            if not key:
                continue
            yield key, read_vec_flt(rxfile)
    finally:
        _maybe_close(fd, file_or_fd)


# ---------------------------------------------------------------------------
# ark+scp writer
# ---------------------------------------------------------------------------

class ArkWriter:
    """Write ``key → matrix/vector`` entries to an ark with a paired scp
    (the reference's ``copy-vector ark:- ark,scp:a.ark,a.scp``); the scp
    offset points at the ``\\x00B`` marker, matching Kaldi's convention."""

    def __init__(self, ark_path: str, scp_path: str | None = None):
        self.ark_path = ark_path
        self._ark = open(ark_path, "wb")
        self._scp = open(scp_path, "w") if scp_path else None

    def write(self, key: str, array: np.ndarray):
        self._ark.write((key + " ").encode("latin1"))
        offset = self._ark.tell()
        buf = _io.BytesIO()
        if array.ndim == 1:
            write_vec_flt(buf, array)
        else:
            write_mat(buf, array)
        self._ark.write(buf.getvalue())
        if self._scp:
            self._scp.write(f"{key} {self.ark_path}:{offset}\n")

    def close(self):
        self._ark.close()
        if self._scp:
            self._scp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
