"""Decoder for the `shorten` lossless audio format (v0-v2), pure Python.

Own copy of ``xvector_tpu/io/shorten.py`` (numpy only).  The reference
recipe never decodes audio itself — every LDC corpus preparation script
emits ``sph2pipe -f wav -p -c N file.sph |`` commands (e.g.
``local/make_sre16_eval_BUT.pl:53``) because SRE04-10 / SWBD deliveries
are NIST SPHERE files whose payload is *embedded-shorten* compressed
(``sample_coding`` of ``pcm,embedded-shorten-v2.00`` or
``ulaw,embedded-shorten-v2.00``), so replacing sph2pipe needs a shorten
decoder.  This one runs a Python loop per sample (seconds per minute of
audio): ``io/wav.py`` prefers libxta's native twin
(``runtime/native.shorten_decode``, bit-identical) and keeps this one as
the fallback without a compiler and as the tests' referee.

Format summary (Tony Robinson's shorten, as consumed by sph2pipe):

* stream = magic ``ajkg`` + 1 version byte, then a bitstream of 32-bit
  big-endian words consumed MSB-first;
* Rice coding: ``uvar(k)`` = unary quotient (``q`` zero bits then a one
  bit) followed by ``k`` low bits MSB-first, value ``(q << k) | low``;
  ``var(k)`` = zigzag-signed ``uvar(k+1)``; ``ulong`` = ``uvar(2)``
  giving a bit count ``n``, then ``uvar(n)``;
* header fields (v>0 all ``ulong``): file type, channel count, block
  size, max LPC order, mean-window length ``nmean``, skip-byte count;
* then a command stream: per-channel blocks coded as DIFF0..3 (fixed
  polynomial predictors of order 0-3), QLPC (quantised LPC), or ZERO,
  with side commands BLOCKSIZE / BITSHIFT / VERBATIM and a QUIT
  terminator.  Channels rotate after each block command.  A running
  per-channel mean of the last ``nmean`` block averages ("offset") is
  the DIFF0/QLPC bias.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

__all__ = ["decode", "MAGIC", "TYPE_ULAW", "TYPE_S16HL", "TYPE_S16LH"]

MAGIC = b"ajkg"

# --- bitstream / coding constants (shorten fixio conventions) ---
ULONGSIZE = 2
NSKIPSIZE = 1
LPCQSIZE = 2
LPCQUANT = 5
XBYTESIZE = 7
ENERGYSIZE = 3
BITSHIFTSIZE = 2
FNSIZE = 2
TYPESIZE = 4
CHANSIZE = 0
VERBATIM_CKSIZE_SIZE = 5
VERBATIM_BYTE_SIZE = 8
NWRAP = 3
DEFAULT_BLOCK_SIZE = 256

# --- commands ---
FN_DIFF0 = 0
FN_DIFF1 = 1
FN_DIFF2 = 2
FN_DIFF3 = 3
FN_QUIT = 4
FN_BLOCKSIZE = 5
FN_BITSHIFT = 6
FN_QLPC = 7
FN_ZERO = 8
FN_VERBATIM = 9

# --- file types ---
TYPE_AU1 = 0
TYPE_S8 = 1
TYPE_U8 = 2
TYPE_S16HL = 3      # 16-bit signed big-endian (SPHERE pcm "10")
TYPE_U16HL = 4
TYPE_S16LH = 5      # 16-bit signed little-endian
TYPE_U16LH = 6
TYPE_ULAW = 7       # raw mu-law bytes
TYPE_AU2 = 8
TYPE_AU3 = 9
TYPE_ALAW = 10

_SUPPORTED_TYPES = {TYPE_S8, TYPE_U8, TYPE_S16HL, TYPE_U16HL, TYPE_S16LH,
                    TYPE_U16LH, TYPE_ULAW, TYPE_ALAW}


class _BitReader:
    """MSB-first reader over 4-byte big-endian words (shorten fixio)."""

    def __init__(self, data: bytes):
        pad = (-len(data)) % 4
        if pad:
            data = data + b"\x00" * pad
        self._words = np.frombuffer(data, dtype=">u4")
        self._wi = 0          # next word index
        self._cur = 0
        self._nbit = 0        # bits remaining in _cur

    def _refill(self):
        if self._wi >= len(self._words):
            raise EOFError("shorten bitstream exhausted")
        self._cur = int(self._words[self._wi])
        self._wi += 1
        self._nbit = 32

    def bit(self) -> int:
        if self._nbit == 0:
            self._refill()
        self._nbit -= 1
        return (self._cur >> self._nbit) & 1

    def uvar(self, k: int) -> int:
        q = 0
        while self.bit() == 0:
            q += 1
        v = q
        for _ in range(k):
            v = (v << 1) | self.bit()
        return v

    def var(self, k: int) -> int:
        u = self.uvar(k + 1)
        return (u >> 1) if (u & 1) == 0 else ~(u >> 1)

    def ulong(self) -> int:
        return self.uvar(self.uvar(ULONGSIZE))


def _rounded_shift_down(x: int, n: int) -> int:
    # shorten's ROUNDEDSHIFTDOWN; arithmetic shift semantics on negatives.
    return x if n == 0 else ((x >> (n - 1)) + 1) >> 1


def _cdiv(a: int, b: int) -> int:
    # C `slong` division truncates toward zero; Python // floors.
    q = abs(a) // b
    return q if a >= 0 else -q


def decode(data: bytes, max_samples: Optional[int] = None
           ) -> Tuple[np.ndarray, int, List[bytes]]:
    """Decode a shorten stream.

    Returns ``(samples, ftype, verbatim)``: ``samples`` is an int32 array
    of shape (n_per_channel, nchan) holding the file-type's raw values
    (linear PCM samples, or mu-law/A-law BYTES for TYPE_ULAW/ALAW);
    ``verbatim`` collects FN_VERBATIM chunks (the original file header
    for non-embedded .shn files).  ``max_samples`` (per channel) stops
    decode early — embedded-shorten SPHERE states sample_count in its
    own header and streams may pad the final block.
    """
    if data[:4] != MAGIC:
        raise ValueError("not a shorten stream (bad magic)")
    version = data[4]
    if version > 2:
        raise ValueError(f"unsupported shorten version {version}")
    br = _BitReader(data[5:])

    def uint_get(k: int) -> int:
        # header fields are uvar in v0, ulong in v1/v2
        return br.uvar(k) if version == 0 else br.ulong()

    ftype = uint_get(TYPESIZE)
    nchan = uint_get(CHANSIZE)
    blocksize = uint_get(DEFAULT_BLOCK_SIZE.bit_length() - 1)
    maxnlpc = uint_get(LPCQSIZE)
    nmean = uint_get(0)
    nskip = uint_get(NSKIPSIZE)
    for _ in range(nskip):
        br.uvar(XBYTESIZE)
    if not (1 <= nchan <= 8):
        raise ValueError(f"implausible shorten channel count {nchan}")
    if ftype not in _SUPPORTED_TYPES:
        raise ValueError(f"unsupported shorten file type {ftype}")
    # same sanity caps as the C++ port: corrupt headers must fail
    # cleanly, not attempt multi-TB allocations
    if not (1 <= blocksize <= (1 << 20)):
        raise ValueError(f"implausible shorten blocksize {blocksize}")
    if not (0 <= maxnlpc <= 1024):
        raise ValueError(f"implausible shorten maxnlpc {maxnlpc}")
    lpcqoffset = (1 << LPCQUANT) if version >= 2 else 0
    type_mean = {TYPE_U8: 0x80, TYPE_U16HL: 0x8000, TYPE_U16LH: 0x8000
                 }.get(ftype, 0)

    nwrap = max(NWRAP, maxnlpc)
    # per-channel: history of nwrap samples + running block-mean window
    hist = [np.zeros(nwrap, np.int64) for _ in range(nchan)]
    offsets = [[type_mean] * max(1, nmean) for _ in range(nchan)]
    out: List[List[np.ndarray]] = [[] for _ in range(nchan)]
    out_count = 0
    verbatim: List[bytes] = []
    bitshift = 0
    chan = 0

    while True:
        cmd = br.uvar(FNSIZE)
        if cmd == FN_QUIT:
            break
        if cmd == FN_BLOCKSIZE:
            blocksize = uint_get(DEFAULT_BLOCK_SIZE.bit_length() - 1)
            if not (1 <= blocksize <= (1 << 20)):
                raise ValueError(f"bad shorten blocksize {blocksize}")
            continue
        if cmd == FN_BITSHIFT:
            bitshift = br.uvar(BITSHIFTSIZE)
            if bitshift > 31:       # same guard as the C++ port (-15)
                raise ValueError(f"bad shorten bitshift {bitshift}")
            continue
        if cmd == FN_VERBATIM:
            n = br.uvar(VERBATIM_CKSIZE_SIZE)
            verbatim.append(bytes(br.uvar(VERBATIM_BYTE_SIZE) & 0xFF
                                  for _ in range(n)))
            continue
        if cmd not in (FN_ZERO, FN_DIFF0, FN_DIFF1, FN_DIFF2, FN_DIFF3,
                       FN_QLPC):
            raise ValueError(f"bad shorten command {cmd}")

        if cmd != FN_ZERO:
            resn = br.uvar(ENERGYSIZE)
            if version == 0:
                resn -= 1
            if not (0 <= resn <= 48):   # same guard as the C++ port
                raise ValueError(f"bad shorten residual width {resn}")
        # per-channel DC offset from the running block-mean window
        off = offsets[chan]
        if nmean == 0:
            coffset = off[0]
        else:
            s = (nmean // 2) if version >= 2 else 0
            s += sum(off)
            coffset = _cdiv(s, nmean) if version < 2 \
                else _rounded_shift_down(_cdiv(s, nmean), bitshift)

        h = hist[chan]
        buf = np.empty(blocksize, np.int64)
        if cmd == FN_ZERO:
            buf[:] = 0
        elif cmd == FN_DIFF0:
            for i in range(blocksize):
                buf[i] = br.var(resn) + coffset
        elif cmd == FN_DIFF1:
            prev = h[-1]
            for i in range(blocksize):
                prev = br.var(resn) + prev
                buf[i] = prev
        elif cmd == FN_DIFF2:
            p1, p2 = h[-1], h[-2]
            for i in range(blocksize):
                v = br.var(resn) + 2 * p1 - p2
                buf[i] = v
                p2, p1 = p1, v
        elif cmd == FN_DIFF3:
            p1, p2, p3 = h[-1], h[-2], h[-3]
            for i in range(blocksize):
                v = br.var(resn) + 3 * p1 - 3 * p2 + p3
                buf[i] = v
                p3, p2, p1 = p2, p1, v
        else:  # FN_QLPC
            nlpc = br.uvar(LPCQSIZE)
            if nlpc > nwrap:
                raise ValueError("shorten LPC order exceeds declared max")
            qlpc = [br.var(LPCQUANT) for _ in range(nlpc)]
            # prediction runs in the coffset-subtracted domain
            ext = np.concatenate([h[len(h) - nlpc:] - coffset,
                                  np.zeros(blocksize, np.int64)]) \
                if nlpc else np.zeros(blocksize, np.int64)
            for i in range(blocksize):
                s = lpcqoffset
                for j in range(nlpc):
                    s += qlpc[j] * int(ext[nlpc + i - j - 1])
                ext[nlpc + i] = br.var(resn) + (int(s) >> LPCQUANT)
            buf[:] = ext[nlpc:] + coffset

        if nmean > 0:
            s = (blocksize // 2) if version >= 2 else 0
            s += int(buf.sum())
            off.pop(0)
            m = _cdiv(s, blocksize)
            off.append((m << bitshift) if version >= 2 else m)
        # history holds pre-bitshift values (prediction domain)
        if blocksize >= nwrap:
            hist[chan] = buf[blocksize - nwrap:].copy()
        else:
            hist[chan] = np.concatenate([h[blocksize:], buf])
        out[chan].append(buf << bitshift if bitshift else buf)
        if chan == nchan - 1:
            out_count += blocksize
            if max_samples is not None and out_count >= max_samples:
                break
        chan = (chan + 1) % nchan

    n = min(len(c) for c in
            (np.concatenate(o) if o else np.empty(0, np.int64)
             for o in out)) if nchan > 1 else None
    cols = []
    for o in out:
        c = np.concatenate(o) if o else np.empty(0, np.int64)
        cols.append(c[:n] if n is not None else c)
    samples = np.stack(cols, axis=1).astype(np.int32)
    if max_samples is not None:
        samples = samples[:max_samples]
    return samples, ftype, verbatim
