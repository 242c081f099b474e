"""Kaldi ark/scp binary interchange for the extraction path.

Own copy of what extraction needs from ``xvector_tpu/io/kaldi_ark.py``
(the port imports nothing of that package): rspecifier parsing with pipe
support, float matrices (including compressed CM/CM2/CM3 reads and the
CM/CM2 writer), float vectors (one by one, or in bulk as an (N, dim)
matrix for the back end), int vectors, posteriors, segments, and the
ark+scp writer.  ``read_mat_ark_fast``, ``read_vec_flt_ark_fast`` and
``read_vec_flt_matrix`` route plain ark files and ``cmd |`` pipes through
libxta's sequential decoder (``runtime/native.py``) when a compiler is
present, and through the Python reader otherwise; both give the same
keys and float32 values.

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

__all__ = ["open_or_fd", "read_mat", "read_mat_ark", "read_mat_ark_fast",
           "read_mat_scp", "write_mat", "read_vec_flt", "read_vec_flt_ark",
           "read_vec_flt_scp", "read_vec_flt_ark_fast",
           "read_vec_flt_matrix", "write_vec_flt", "read_vec_int",
           "write_vec_int", "read_vec_int_ark", "read_post_ark",
           "read_segments_as_bool_vec", "ArkWriter"]


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


def _float_to_uint16(f: np.ndarray, gmin: float, grange: float) -> np.ndarray:
    scaled = (np.asarray(f, np.float64) - gmin) / grange * 65535.0
    return np.clip(np.round(scaled), 0, 65535).astype("<u2")


def _write_compressed_mat(fd, mat: np.ndarray):
    """Encode Kaldi CompressedMatrix (inverse of :func:`_read_compressed_mat`)
    as ``copy-feats --compress=true`` would: the per-column percentile
    format ``CM`` for matrices of more than 8 rows, two-byte-linear ``CM2``
    otherwise."""
    m = np.asarray(mat, np.float64)
    rows, cols = m.shape
    gmin = float(m.min()) if m.size else 0.0
    grange = (float(m.max()) - gmin) if m.size else 1.0
    if grange <= 0.0:
        grange = 1e-5
    if rows <= 8:
        fd.write(b"CM2")
        fd.write(struct.pack("<ffii", gmin, grange, rows, cols))
        codes = _float_to_uint16(m, gmin, grange)
        fd.write(np.ascontiguousarray(codes).tobytes())
        return
    fd.write(b"CM ")
    fd.write(struct.pack("<ffii", gmin, grange, rows, cols))
    cm = m.T                                   # column-major like Kaldi
    srt = np.sort(cm, axis=1)
    quarter = rows // 4
    # per-column percentile header, quantized then forced strictly
    # increasing in uint16 space (Kaldi ComputeColHeader semantics)
    hdr = np.stack([_float_to_uint16(srt[:, 0], gmin, grange),
                    _float_to_uint16(srt[:, quarter], gmin, grange),
                    _float_to_uint16(srt[:, 3 * quarter], gmin, grange),
                    _float_to_uint16(srt[:, rows - 1], gmin, grange)],
                   axis=1).astype(np.int64)
    # cap each entry below the one above (so the ladder cannot overflow
    # the top), then push each entry above the one below (so it cannot
    # underflow past 0)
    for i in range(2, -1, -1):
        hdr[:, i] = np.minimum(hdr[:, i], hdr[:, i + 1] - 1)
    hdr[:, 0] = np.maximum(hdr[:, 0], 0)
    for i in range(1, 4):
        hdr[:, i] = np.maximum(hdr[:, i], hdr[:, i - 1] + 1)
    hdr = np.minimum(hdr, 65535).astype("<u2")
    fd.write(np.ascontiguousarray(hdr).tobytes())
    c0, c25, c75, c100 = (
        _uint16_to_float(hdr[:, i].astype(np.float64), gmin, grange)[:, None]
        for i in range(4))
    # piecewise-linear inverse of CharToFloat, per segment
    lo = np.clip(np.round(64.0 * (cm - c0) / (c25 - c0)), 0, 64)
    mid = np.clip(np.round(64.0 + 128.0 * (cm - c25) / (c75 - c25)), 65, 192)
    hi = np.clip(np.round(192.0 + 63.0 * (cm - c75) / (c100 - c75)), 193, 255)
    codes = np.where(cm < c25, lo, np.where(cm < c75, mid, hi))
    fd.write(np.ascontiguousarray(codes.astype(np.uint8)).tobytes())


def write_mat(file_or_fd, mat: np.ndarray, key: str = "",
              compress: bool = False):
    """Write one float32/float64 matrix in Kaldi binary format;
    ``compress=True`` writes a Kaldi CompressedMatrix (lossy uint8/uint16
    codes, ~4x smaller)."""
    fd = open_or_fd(file_or_fd, mode="wb")
    try:
        if key:
            fd.write((key + " ").encode("latin1"))
        fd.write(b"\x00B")
        if compress:
            _write_compressed_mat(fd, mat)
            return
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


def read_mat_ark_fast(rxspec) -> Iterator[Tuple[str, np.ndarray]]:
    """``read_mat_ark`` that routes plain binary ark files and ``cmd |``
    pipes (the reference's extraction rspecifier,
    ``extract_xvectors.sh:68``) through libxta's sequential decoder
    (``xta_stream_*``) when it is available; stdin, gzip and open files
    take the Python reader.  Yields identical (key, float32 matrix) pairs
    either way."""
    it = _native_stream_iter(rxspec)
    if it is not None:
        yield from it
        return
    yield from read_mat_ark(rxspec)


def _strip_ark_options(rxspec: str) -> str:
    head, sep, tail = rxspec.partition(":")
    if sep and all(tok in ("ark", "t", "b", "p", "o", "s", "cs", "f", "n")
                   for tok in head.split(",")):
        return tail
    return rxspec


def _plain_ark_file(spec: str) -> bool:
    return bool(spec and not spec.startswith("|") and spec != "-"
                and not spec.endswith(".gz") and os.path.exists(spec))


def _pipe_into(spec: str, reader):
    """Run ``spec``'s command, hand its stdout's descriptor to ``reader``
    and yield what the iterable it returns yields; a nonzero status after
    a full read raises.  A consumer that stops early SIGPIPEs the producer
    (141 via the shell, -13 raw), which is no failure."""
    proc = subprocess.Popen(spec[:-1].strip(), shell=True,
                            stdout=subprocess.PIPE)
    drained = False
    try:
        yield from reader(proc.stdout.fileno())
        drained = True
    finally:
        proc.stdout.close()
        rc = proc.wait()
        if drained and rc != 0:
            raise IOError(f"pipe subprocess exited with {rc}")


def _native_stream_iter(rxspec):
    """Native sequential decode of a plain ark file or a ``cmd |`` pipe;
    None when libxta is unavailable or the spec shape isn't covered."""
    if not isinstance(rxspec, str):
        return None
    from ..runtime import native
    if not native.available():
        return None
    spec = _strip_ark_options(rxspec)
    if spec.endswith("|"):
        return _pipe_into(spec, native.ArkStream)
    if _plain_ark_file(spec):
        return iter(native.ArkStream(spec))
    return None


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


def read_vec_flt_ark_fast(rxspec) -> Iterator[Tuple[str, np.ndarray]]:
    """``read_vec_flt_ark`` through libxta's stream where it is available
    (FV/DV entries come back from it as 1×dim matrices); the Python
    reader otherwise."""
    it = _native_stream_iter(rxspec)
    if it is not None:
        for key, mat in it:
            yield key, mat.reshape(-1)
        return
    yield from read_vec_flt_ark(rxspec)


def read_vec_flt_matrix(rxspec, dim_hint: int = 512):
    """Slurp an ark of same-dim float vectors as ``(keys, (N, dim)
    float32)``, the natural shape for the PLDA back end.  ``rxspec`` is
    an rspecifier as :func:`open_or_fd` takes it (``ark:`` options, a
    ``cmd |`` pipe, a path, an open file).  An empty ark gives
    ``([], (0, dim_hint))``.  Plain files and pipes go through libxta's
    bulk reader (one native call per 64k entries) where it is available;
    everything else reads entry by entry."""
    from ..runtime import native
    if isinstance(rxspec, str) and native.available():
        spec = _strip_ark_options(rxspec)
        if spec.endswith("|"):
            (out,) = _pipe_into(
                spec, lambda fd: [native.read_vec_matrix(fd, dim_hint)])
            return out
        if _plain_ark_file(spec):
            return native.read_vec_matrix(spec, dim_hint)
    keys, rows = [], []
    for key, vec in read_vec_flt_ark(rxspec):
        keys.append(key)
        rows.append(vec)
    if not rows:
        return [], np.empty((0, dim_hint), np.float32)
    return keys, np.stack(rows).astype(np.float32)


# ---------------------------------------------------------------------------
# Int vectors
# ---------------------------------------------------------------------------

def read_vec_int(file_or_fd) -> np.ndarray:
    fd = open_or_fd(file_or_fd)
    try:
        binary = fd.read(2)
        if binary == b"\x00B":
            dim = _read_basic_int32(fd)
            # each element: size byte + int32
            buf = np.frombuffer(fd.read(dim * 5), dtype=np.uint8)
            return buf.reshape(dim, 5)[:, 1:].copy().view("<i4").ravel()
        rest = (binary + fd.read()).decode("utf-8").strip()
        rest = rest.strip("[] ")
        return np.array(rest.split(), dtype=np.int32)
    finally:
        _maybe_close(fd, file_or_fd)


def write_vec_int(file_or_fd, vec: np.ndarray, key: str = ""):
    fd = open_or_fd(file_or_fd, mode="wb")
    try:
        if key:
            fd.write((key + " ").encode("latin1"))
        fd.write(b"\x00B")
        _write_basic_int32(fd, len(vec))
        out = np.empty((len(vec), 5), dtype=np.uint8)
        out[:, 0] = 4
        out[:, 1:] = np.asarray(vec, dtype="<i4")[:, None].view(np.uint8)
        fd.write(out.tobytes())
    finally:
        _maybe_close(fd, file_or_fd)


def read_vec_int_ark(file_or_fd) -> Iterator[Tuple[str, np.ndarray]]:
    fd = open_or_fd(file_or_fd)
    try:
        while True:
            key = _read_key(fd)
            if key is None:
                return
            _expect_binary_entry(fd, key)
            dim = _read_basic_int32(fd)
            buf = np.frombuffer(fd.read(dim * 5), dtype=np.uint8)
            yield key, buf.reshape(dim, 5)[:, 1:].copy().view("<i4").ravel()
    finally:
        _maybe_close(fd, file_or_fd)


# ---------------------------------------------------------------------------
# Posteriors & segments (kaldi_io.py:553-697 surface)
# ---------------------------------------------------------------------------

def read_post_ark(file_or_fd):
    """Yield (key, posteriors) where posteriors is a list per frame of
    (int id, float weight) pairs — Kaldi Posterior binary format."""
    fd = open_or_fd(file_or_fd)
    try:
        while True:
            key = _read_key(fd)
            if key is None:
                return
            _expect_binary_entry(fd, key)
            num_frames = _read_basic_int32(fd)
            post = []
            for _ in range(num_frames):
                n = _read_basic_int32(fd)
                frame = []
                for _ in range(n):
                    idx = _read_basic_int32(fd)
                    size = fd.read(1)
                    if size != b"\x04":
                        raise ValueError("expected float size byte")
                    (w,) = struct.unpack("<f", fd.read(4))
                    frame.append((idx, w))
                post.append(frame)
            yield key, post
    finally:
        _maybe_close(fd, file_or_fd)


def read_segments_as_bool_vec(path: str):
    """Kaldi segments file for one recording → per-frame bool vector at
    100 fps (kaldi_io.py read_segments_as_bool_vec semantics)."""
    segs = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 4:
                segs.append((float(parts[2]), float(parts[3])))
    if not segs:
        return np.zeros(0, dtype=bool)
    end = max(e for _, e in segs)
    vec = np.zeros(int(round(end * 100.0)), dtype=bool)
    for s, e in segs:
        vec[int(round(s * 100.0)): int(round(e * 100.0))] = True
    return vec


# ---------------------------------------------------------------------------
# ark+scp writer
# ---------------------------------------------------------------------------

class ArkWriter:
    """Write ``key → matrix/vector`` entries to an ark with a paired scp
    (the reference's ``copy-vector ark:- ark,scp:a.ark,a.scp``); the scp
    offset points at the ``\\x00B`` marker, matching Kaldi's convention.
    ``compress=True`` writes matrices as Kaldi CompressedMatrix."""

    def __init__(self, ark_path: str, scp_path: str | None = None,
                 compress: bool = False):
        self.ark_path = ark_path
        self.compress = compress
        self._ark = open(ark_path, "wb")
        self._scp = open(scp_path, "w") if scp_path else None

    def write(self, key: str, array: np.ndarray):
        self._ark.write((key + " ").encode("latin1"))
        offset = self._ark.tell()
        buf = _io.BytesIO()
        if array.ndim == 1:
            write_vec_flt(buf, array)
        else:
            write_mat(buf, array, compress=self.compress)
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
