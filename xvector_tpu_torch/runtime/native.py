"""ctypes bindings for libxta, the port's native host data plane.

Own copy of ``xvector_tpu/runtime/native.py`` over the port's own source,
``csrc/xta_io.cc`` (host C++: OpenMP Kaldi ark decode, float16 chunk
gather, a sequential ark reader, the shorten decoder).  Every entry point
has a pure-Python fallback in the package, so the framework runs on a
machine without a C++ compiler: there :func:`get_lib` returns None,
:func:`available` is False and
:func:`~xvector_tpu_torch.data.archives.materialize_archive_native`
returns False.  Where a compiler is present, a build that fails raises.

The library is built at first use, the way ``ops/_build.py`` builds the
CUDA sources: ``g++`` into ``xvector_tpu_torch/_build/<hash>/libxta.so``
(listed in ``.gitignore``), keyed by a hash of the source, the flags, the
compiler and the host CPU's feature flags (``-march=native`` code runs
only where it was built), through a temporary file named by the pid and
``os.replace``.  A process therefore never loads half a library, however
many processes build at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["get_lib", "available", "stream_supported", "shorten_supported",
           "threads", "lib_path", "mat_shape", "read_mat", "shorten_decode",
           "ArkStream", "read_vec_matrix", "materialize_chunks"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "xta_io.cc"
BUILD_ROOT = _PKG / "_build"
# the JAX package's Makefile flags, plus -ffp-contract=off: no fused
# multiply-adds, so the decoders round as the numpy readers do.  -fopenmp
# is dropped where the toolchain has no OpenMP runtime (_openmp).
CXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-fPIC",
             "-fopenmp", "-std=c++17", "-Wall", "-shared")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _compiler() -> Optional[str]:
    """The C++ compiler (``$CXX``, else ``g++``) or None if absent."""
    return shutil.which(os.environ.get("CXX") or "g++")


def _cpu_flags() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith((b"flags", b"Features")):
                    return line
    except OSError:
        pass
    return os.uname().machine.encode()


def lib_path(cxx: str) -> Path:
    """Where the library built by ``cxx`` from the current source lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(os.path.realpath(cxx).encode())
    h.update(_cpu_flags())
    return BUILD_ROOT / h.hexdigest()[:16] / "libxta.so"


def _openmp(cxx: str, scratch: Path) -> bool:
    """Whether ``cxx -fopenmp`` links a shared library here: a g++ without
    libgomp (its ``libgomp.spec``) refuses the flag outright."""
    src = scratch / f"omp.{os.getpid()}.cc"
    out = scratch / f"omp.{os.getpid()}.so"
    src.write_text("int xta_omp_probe() { return 0; }\n")
    try:
        return subprocess.run(
            [cxx, "-fopenmp", "-fPIC", "-shared", "-o", str(out), str(src)],
            capture_output=True).returncode == 0
    finally:
        src.unlink(missing_ok=True)
        out.unlink(missing_ok=True)


def _build(cxx: str) -> Path:
    out = lib_path(cxx)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"libxta.{os.getpid()}.tmp.so")
    flags = [f for f in CXX_FLAGS
             if f != "-fopenmp" or _openmp(cxx, out.parent)]
    proc = subprocess.run([cxx, *flags, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building libxta failed (rc {proc.returncode}):"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)   # atomic: a reader never sees half a library
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_i32p = ctypes.POINTER(ctypes.c_int32)
    c_i64p = ctypes.POINTER(ctypes.c_int64)
    lib.xta_version.restype = ctypes.c_int
    lib.xta_threads.restype = ctypes.c_int
    lib.xta_mat_shape.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                  c_i32p, c_i32p]
    lib.xta_mat_shape.restype = ctypes.c_int
    lib.xta_read_mat.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, c_i32p, c_i32p]
    lib.xta_read_mat.restype = ctypes.c_int
    lib.xta_materialize.argtypes = [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_char_p), c_i64p, c_i32p,
        c_i32p, c_i32p, ctypes.POINTER(ctypes.c_uint16), ctypes.c_int64,
        ctypes.c_int64]
    lib.xta_materialize.restype = ctypes.c_int
    lib.xta_stream_open.argtypes = [ctypes.c_char_p]
    lib.xta_stream_open.restype = ctypes.c_void_p
    lib.xta_stream_open_fd.argtypes = [ctypes.c_int]
    lib.xta_stream_open_fd.restype = ctypes.c_void_p
    lib.xta_stream_next.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_int64, c_i32p, c_i32p]
    lib.xta_stream_next.restype = ctypes.c_int
    lib.xta_stream_data.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.xta_stream_data.restype = ctypes.c_int
    lib.xta_stream_read_vecs.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, c_i32p, c_i64p]
    lib.xta_stream_read_vecs.restype = ctypes.c_int64
    lib.xta_stream_close.argtypes = [ctypes.c_void_p]
    lib.xta_stream_close.restype = None
    lib.xta_shorten_probe.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                      c_i32p, c_i32p]
    lib.xta_shorten_probe.restype = ctypes.c_int
    lib.xta_shorten_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                       c_i32p, ctypes.c_int64]
    lib.xta_shorten_decode.restype = ctypes.c_int64
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """libxta, built first if needed; None when no compiler is present.
    Raises if the build fails or the built library does not load."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    cxx = _compiler()
    if cxx is None:
        _tried = True
        return None
    _lib = _bind(ctypes.CDLL(str(_build(cxx))))
    _tried = True
    return _lib


def available() -> bool:
    return get_lib() is not None


def stream_supported() -> bool:
    """Whether the streaming ark reader (``ArkStream``) is there: the port
    builds libxta from its own source, so whenever libxta is."""
    return available()


def shorten_supported() -> bool:
    """Whether the native shorten decoder is there (as
    :func:`stream_supported`)."""
    return available()


def threads() -> int:
    """Threads libxta's materialisation uses (1 in a build without
    OpenMP)."""
    return _need().xta_threads()


def _need() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("libxta unavailable: no C++ compiler found "
                           "(set CXX or put g++ on PATH)")
    return lib


def mat_shape(path: str, offset: int = 0) -> Tuple[int, int]:
    """(rows, cols) of a Kaldi matrix at a byte offset — header-only probe,
    no payload decode."""
    lib = _need()
    rows = ctypes.c_int32()
    cols = ctypes.c_int32()
    if lib.xta_mat_shape(path.encode(), offset, ctypes.byref(rows),
                         ctypes.byref(cols)):
        raise IOError(f"xta_mat_shape failed for {path}:{offset}")
    return rows.value, cols.value


def read_mat(path: str, offset: int = 0) -> np.ndarray:
    """Native Kaldi matrix read (FM/DM/CM/CM2/CM3) at a byte offset."""
    lib = _need()
    rows, cols = mat_shape(path, offset)
    out = np.empty((rows, cols), np.float32)
    r, c = ctypes.c_int32(), ctypes.c_int32()
    rc = lib.xta_read_mat(
        path.encode(), offset,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size,
        ctypes.byref(r), ctypes.byref(c))
    if rc:
        raise IOError(f"xta_read_mat failed ({rc}) for {path}:{offset}")
    return out


def shorten_decode(payload: bytes, sample_count: Optional[int] = None
                   ) -> np.ndarray:
    """Native shorten decode → (n, nchan) int32 (raw file-type values).

    sample_count (per channel) bounds the output; embedded-shorten
    SPHERE always states it in its own header.  Pass None to decode the
    whole stream (capacity then estimated from the payload size)."""
    lib = _need()
    nchan = ctypes.c_int32()
    ftype = ctypes.c_int32()
    rc = lib.xta_shorten_probe(payload, len(payload),
                               ctypes.byref(nchan), ctypes.byref(ftype))
    if rc:
        raise ValueError(f"shorten probe failed ({rc})")
    if sample_count is None:
        # initial guess: >= 1 bit per sample; FN_ZERO blocks can beat
        # that arbitrarily, so grow and redecode until the stream ends
        # before the buffer does (rows < cap <=> hit QUIT/EOF)
        cap = max(1024, 8 * len(payload) // nchan.value + 512)
    else:
        cap = sample_count
    while True:
        out = np.empty((cap, nchan.value), np.int32)
        rows = lib.xta_shorten_decode(
            payload, len(payload),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap)
        if rows < 0:
            raise ValueError(f"shorten decode failed ({rows})")
        if sample_count is not None:
            return out[:min(rows, sample_count)]
        if rows < cap:
            return out[:rows]
        if cap >= (1 << 31):
            raise ValueError("shorten stream exceeds 2^31 samples")
        cap *= 4


class ArkStream:
    """Sequential native iterator over a binary ark file OR an open file
    descriptor (pass an int — e.g. a pipe's read end): yields ``(key,
    (rows, cols) float32 matrix)``, the C++ replacement for the Python
    ``read_mat_ark`` loop.  FV/DV vector entries come back as 1×dim
    matrices."""

    _KEY_CAP = 1024

    def __init__(self, path_or_fd):
        self._h = None
        self._lib = _need()
        if isinstance(path_or_fd, int):
            self._h = self._lib.xta_stream_open_fd(path_or_fd)
        else:
            self._h = self._lib.xta_stream_open(path_or_fd.encode())
        if not self._h:
            self._h = None
            raise IOError(f"cannot open ark {path_or_fd}")
        self._path = str(path_or_fd)

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[str, np.ndarray]:
        if self._h is None:
            raise StopIteration
        key = ctypes.create_string_buffer(self._KEY_CAP)
        rows = ctypes.c_int32()
        cols = ctypes.c_int32()
        rc = self._lib.xta_stream_next(self._h, key, self._KEY_CAP,
                                       ctypes.byref(rows), ctypes.byref(cols))
        if rc == 1:
            self.close()
            raise StopIteration
        if rc:
            self.close()
            raise IOError(f"malformed ark entry in {self._path} ({rc})")
        out = np.empty((rows.value, cols.value), np.float32)
        rc = self._lib.xta_stream_data(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.size)
        if rc:
            self.close()
            raise IOError(f"ark payload read failed in {self._path} ({rc})")
        return key.value.decode("latin1"), out

    def close(self):
        if self._h is not None:
            self._lib.xta_stream_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


def read_vec_matrix(path_or_fd, dim_hint: int = 512,
                    batch_rows: int = 65536):
    """Bulk-read an ark of same-dim float vectors natively: returns
    ``(keys, (N, dim) float32)`` with ONE ctypes crossing per
    ``batch_rows`` entries (reading 100k PLDA x-vectors one entry at a
    time is Python-overhead-bound)."""
    lib = _need()
    stream = ArkStream(path_or_fd)
    key_stride = 1024        # matches the C key capacity
    keys = []
    chunks = []
    dim = None
    try:
        while True:
            # first call reads ONE row with a generous float budget to
            # learn the true dim; later calls size buffers exactly
            cap = batch_rows if dim else 1
            buf = np.empty(cap * dim if dim else max(dim_hint, 1 << 20),
                           np.float32)
            # np.empty, not create_string_buffer: no 16 MB memset per batch
            kbuf = np.empty(cap * key_stride, np.uint8)
            dim_out = ctypes.c_int32()
            kused = ctypes.c_int64()
            n = lib.xta_stream_read_vecs(
                stream._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                buf.size, kbuf.ctypes.data_as(ctypes.c_char_p),
                cap * key_stride, cap,
                ctypes.byref(dim_out), ctypes.byref(kused))
            if n == -13:
                raise IOError(
                    "vector dim exceeds the probe budget "
                    f"({max(dim_hint, 1 << 20)} floats); pass a larger "
                    "dim_hint")
            if n < 0:
                raise IOError(f"bulk vector read failed ({n})")
            if n == 0:
                break
            if dim is None:
                dim = dim_out.value
            elif dim_out.value != dim:
                raise IOError("ragged vector dims in ark")
            chunks.append(buf[: n * dim].reshape(n, dim).copy())
            # split ONLY on the \n separators the C side wrote —
            # splitlines() would also split on \x1c-\x1e / \x85 bytes
            # that are legal inside Kaldi keys
            blob = kbuf[: kused.value].tobytes().decode("latin1")
            keys.extend(blob.split("\n")[:-1])
            if n < cap:
                break
    finally:
        stream.close()
    if not chunks:
        return [], np.empty((0, dim_hint), np.float32)
    return keys, (chunks[0] if len(chunks) == 1
                  else np.concatenate(chunks, axis=0))


def materialize_chunks(sources: Sequence[Tuple[str, int, int, int]],
                       pad_len: int, feat_dim: int) -> np.ndarray:
    """Gather chunks into a float16 tensor via the native function.

    sources: per-chunk (ark_path, byte_offset, row_begin, length); chunk i
    lands in row i, zero-padded to ``pad_len`` frames.
    Returns (len(sources), pad_len, feat_dim) float16.
    """
    lib = _need()
    n = len(sources)
    paths = (ctypes.c_char_p * n)(*[s[0].encode() for s in sources])
    offsets = np.asarray([s[1] for s in sources], np.int64)
    row_begin = np.asarray([s[2] for s in sources], np.int32)
    lengths = np.asarray([s[3] for s in sources], np.int32)
    if n and (lengths.max() > pad_len or row_begin.min() < 0):
        raise ValueError(f"a chunk longer than pad_len={pad_len} or with "
                         "a negative start")
    out_index = np.arange(n, dtype=np.int32)
    out = np.zeros((n, pad_len, feat_dim), np.float16)
    rc = lib.xta_materialize(
        n, paths,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        row_begin.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_index.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        pad_len, feat_dim)
    if rc:
        raise IOError(f"xta_materialize failed with status {rc}")
    return out
