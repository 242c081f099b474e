// libxta — native data-plane functions of the xvector_tpu_torch port.
//
// Own copy of the JAX package's xvector_tpu/runtime/xta_io.cc (host C++,
// no GPU code).  The reference offloads its data plane to external Kaldi
// C++ binaries (copy-vector, feat-to-dim, the ark-reading inner loops of
// create_tar_files.py run in Python).  Here the host-side hot loops live in
// one small C++ library driven from Python via ctypes
// (xvector_tpu_torch/runtime/native.py):
//
//   * xta_read_mat       — Kaldi binary float/double matrix decode at a
//                          byte offset (the scp random-access path)
//   * xta_read_compressed — Kaldi CompressedMatrix (CM format 1) decode
//   * xta_materialize    — archive materialisation: for a batch of chunk
//                          descriptors, decode each source matrix once,
//                          slice the requested frame ranges, convert to
//                          fp16, and scatter into the caller's output
//                          tensor.  OpenMP-parallel over chunks with a
//                          per-thread matrix cache.
//   * xta_stream_*       — sequential binary-ark iterator (the streaming
//                          read loop of extraction, models.py:373 /
//                          kaldi_io.read_mat_ark in the reference): one
//                          pass, no per-entry reopen/seek.
//   * xta_shorten_*      — the shorten decoder of embedded-shorten SPHERE.
//
// Built at first use by runtime/native.py:
//   g++ -O3 -march=native -ffp-contract=off -fPIC -fopenmp -std=c++17 -Wall
//       -shared
// (without -fopenmp where the toolchain has no OpenMP runtime: every
// OpenMP construct here is guarded by _OPENMP, so the build runs serial)
// The decoders evaluate in the order (and, with -ffp-contract=off, the
// roundings) of the package's numpy readers, and the float16 cast rounds
// to nearest even as numpy's does, so native and Python reads give the
// same bits.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

#include <unistd.h>  // dup (xta_stream_open_fd)

namespace {

// ---------------------------------------------------------------------------
// fp32 -> fp16 (IEEE binary16), round-to-nearest-even.
// ---------------------------------------------------------------------------
static inline uint16_t f32_to_f16(float f) {
  uint32_t x;
  std::memcpy(&x, &f, 4);
  const uint32_t sign = (x >> 16) & 0x8000u;
  x &= 0x7fffffffu;
  if (x >= 0x47800000u) {                 // overflow / inf / nan
    return sign | (x > 0x7f800000u ? 0x7e00u : 0x7c00u);
  }
  if (x < 0x38800000u) {                  // subnormal / zero
    if (x < 0x33000000u) return sign;     // underflow to zero
    const int shift = 126 - (x >> 23);
    uint32_t mant = (x & 0x7fffffu) | 0x800000u;
    uint32_t rounded = mant >> shift;
    // round to nearest even, as numpy's float16 cast
    const uint32_t rest = mant & ((1u << shift) - 1u);
    const uint32_t halfway = 1u << (shift - 1);
    if (rest > halfway || (rest == halfway && (rounded & 1u))) {
      rounded += 1u;
    }
    return sign | (uint16_t)rounded;
  }
  uint32_t half = ((x >> 13) & 0x3fffu) | (((x >> 23) - 112) << 10);
  // round-to-nearest-even on the dropped 13 bits
  uint32_t dropped = x & 0x1fffu;
  if (dropped > 0x1000u || (dropped == 0x1000u && (half & 1u))) half += 1u;
  return sign | (uint16_t)half;
}

struct Matrix {
  int rows = 0, cols = 0;
  std::vector<float> data;
};

static int read_exact(std::FILE* f, void* dst, size_t n) {
  return std::fread(dst, 1, n, f) == n ? 0 : -1;
}

// Sanity bounds on matrix dims read from (possibly corrupt) files: a
// resize() from unvalidated dims would throw across the C ABI and
// std::terminate the embedding Python process.
static inline bool dims_ok(int64_t rows, int64_t cols) {
  return rows >= 0 && cols >= 0 && rows <= (1 << 28) &&
         cols <= (1 << 22) && rows * cols <= (int64_t)1 << 31;
}

// Decode a matrix payload given its already-consumed 3-byte format tag.
static int decode_mat_body(std::FILE* f, const char* hdr, Matrix* out) {
  auto read_i32 = [&](int32_t* v) -> int {
    unsigned char size;
    if (read_exact(f, &size, 1) || size != 4) return -1;
    return read_exact(f, v, 4);
  };
  if (!std::memcmp(hdr, "FM ", 3) || !std::memcmp(hdr, "DM ", 3)) {
    const bool dbl = hdr[0] == 'D';
    int32_t rows, cols;
    if (read_i32(&rows) || read_i32(&cols)) return -1;
    if (!dims_ok(rows, cols)) return -4;
    out->rows = rows;
    out->cols = cols;
    out->data.resize((size_t)rows * cols);
    if (dbl) {
      std::vector<double> tmp((size_t)rows * cols);
      if (read_exact(f, tmp.data(), tmp.size() * 8)) return -1;
      for (size_t i = 0; i < tmp.size(); ++i) out->data[i] = (float)tmp[i];
    } else {
      if (read_exact(f, out->data.data(), out->data.size() * 4)) return -1;
    }
    return 0;
  }
  if (!std::memcmp(hdr, "CM2", 3)) {   // flat uint16 linear encoding
    float gmin, grange;
    int32_t rows, cols;
    if (read_exact(f, &gmin, 4) || read_exact(f, &grange, 4) ||
        read_exact(f, &rows, 4) || read_exact(f, &cols, 4))
      return -1;
    if (!dims_ok(rows, cols)) return -4;
    std::vector<uint16_t> codes((size_t)rows * cols);
    if (read_exact(f, codes.data(), codes.size() * 2)) return -1;
    out->rows = rows;
    out->cols = cols;
    out->data.resize(codes.size());
    const double inv = 1.0 / 65535.0;
    for (size_t i = 0; i < codes.size(); ++i)
      out->data[i] = (float)(gmin + grange * (codes[i] * inv));
    return 0;
  }
  if (!std::memcmp(hdr, "CM3", 3)) {   // flat uint8 linear encoding
    float gmin, grange;
    int32_t rows, cols;
    if (read_exact(f, &gmin, 4) || read_exact(f, &grange, 4) ||
        read_exact(f, &rows, 4) || read_exact(f, &cols, 4))
      return -1;
    if (!dims_ok(rows, cols)) return -4;
    std::vector<uint8_t> codes((size_t)rows * cols);
    if (read_exact(f, codes.data(), codes.size())) return -1;
    out->rows = rows;
    out->cols = cols;
    out->data.resize(codes.size());
    for (size_t i = 0; i < codes.size(); ++i)
      out->data[i] = (float)(gmin + (double)grange * codes[i] / 255.0);
    return 0;
  }
  if (!std::memcmp(hdr, "CM ", 3)) {   // CompressedMatrix format 1
    float gmin, grange;
    int32_t rows, cols;
    if (read_exact(f, &gmin, 4) || read_exact(f, &grange, 4) ||
        read_exact(f, &rows, 4) || read_exact(f, &cols, 4))
      return -1;
    if (!dims_ok(rows, cols)) return -4;
    std::vector<uint16_t> hdrs((size_t)cols * 4);
    if (read_exact(f, hdrs.data(), hdrs.size() * 2)) return -1;
    std::vector<uint8_t> codes((size_t)cols * rows);
    if (read_exact(f, codes.data(), codes.size())) return -1;
    out->rows = rows;
    out->cols = cols;
    out->data.resize((size_t)rows * cols);
    const double inv = 1.0 / 65535.0;
    for (int c = 0; c < cols; ++c) {
      const double p0 = gmin + grange * (hdrs[c * 4 + 0] * inv);
      const double p25 = gmin + grange * (hdrs[c * 4 + 1] * inv);
      const double p75 = gmin + grange * (hdrs[c * 4 + 2] * inv);
      const double p100 = gmin + grange * (hdrs[c * 4 + 3] * inv);
      const uint8_t* col = codes.data() + (size_t)c * rows;
      for (int r = 0; r < rows; ++r) {
        const double v = col[r];
        double val;
        if (v <= 64.0)
          val = p0 + (p25 - p0) * (v / 64.0);
        else if (v <= 192.0)
          val = p25 + (p75 - p25) * ((v - 64.0) / 128.0);
        else
          val = p75 + (p100 - p75) * ((v - 192.0) / 63.0);
        out->data[(size_t)r * cols + c] = (float)val;
      }
    }
    return 0;
  }
  return -2;  // unknown header
}

// Decode a Kaldi binary matrix payload starting AFTER the \0B marker.
static int decode_mat(std::FILE* f, Matrix* out) {
  char hdr[3];
  if (read_exact(f, hdr, 3)) return -1;
  return decode_mat_body(f, hdr, out);
}

// Consume n bytes without seeking (works on pipes).
static int skip_bytes(std::FILE* f, int64_t n) {
  char scratch[4096];
  while (n > 0) {
    size_t chunk = n > (int64_t)sizeof(scratch) ? sizeof(scratch)
                                                : (size_t)n;
    if (std::fread(scratch, 1, chunk, f) != chunk) return -1;
    n -= (int64_t)chunk;
  }
  return 0;
}

static int read_mat_at(const char* path, int64_t offset, Matrix* out) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  int rc = -1;
  do {
    if (offset > 0 && std::fseek(f, (long)offset, SEEK_SET)) break;
    char marker[2];
    if (read_exact(f, marker, 2) || marker[0] != '\0' || marker[1] != 'B')
      break;
    rc = decode_mat(f, out);
  } while (false);
  std::fclose(f);
  return rc;
}

// Header-only dims probe: reads the format tag + dims, NO payload (the
// scp random-access path calls this once per utterance just for a row
// count).
static int read_shape_at(const char* path, int64_t offset, int32_t* rows,
                         int32_t* cols) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  int rc = -1;
  do {
    if (offset > 0 && std::fseek(f, (long)offset, SEEK_SET)) break;
    char marker[2];
    if (read_exact(f, marker, 2) || marker[0] != '\0' || marker[1] != 'B')
      break;
    char hdr[3];
    if (read_exact(f, hdr, 3)) break;
    int32_t r, c;
    if (!std::memcmp(hdr, "FM ", 3) || !std::memcmp(hdr, "DM ", 3)) {
      unsigned char dims[10];
      if (read_exact(f, dims, 10) || dims[0] != 4 || dims[5] != 4) break;
      std::memcpy(&r, dims + 1, 4);
      std::memcpy(&c, dims + 6, 4);
    } else if (!std::memcmp(hdr, "CM", 2)) {
      float g2[2];
      if (read_exact(f, g2, 8) || read_exact(f, &r, 4) ||
          read_exact(f, &c, 4))
        break;
    } else {
      rc = -2;
      break;
    }
    if (!dims_ok(r, c)) { rc = -4; break; }
    *rows = r;
    *cols = c;
    rc = 0;
  } while (false);
  std::fclose(f);
  return rc;
}

}  // namespace

extern "C" {

// Probe a matrix's dims — header-only, no payload decode.
int xta_mat_shape(const char* path, int64_t offset, int32_t* rows,
                  int32_t* cols) {
  return read_shape_at(path, offset, rows, cols);
}

// Read a matrix into a caller-provided buffer of capacity cap floats.
int xta_read_mat(const char* path, int64_t offset, float* out, int64_t cap,
                 int32_t* rows, int32_t* cols) {
  Matrix m;
  if (read_mat_at(path, offset, &m)) return -1;
  if ((int64_t)m.data.size() > cap) return -3;
  std::memcpy(out, m.data.data(), m.data.size() * 4);
  *rows = m.rows;
  *cols = m.cols;
  return 0;
}

// Materialise a set of chunks into an fp16 tensor.
//
// n         : number of chunks
// paths     : n C strings — source ark file per chunk
// offsets   : n byte offsets of the \0B marker in the ark
// row_begin : n first-frame indices
// lengths   : n frame counts
// out_index : n destination slot indices into `out`
// out       : fp16 tensor (slots, pad_len, feat_dim), caller-zeroed
// pad_len   : slot length in frames (chunk rows land at [0, length))
// feat_dim  : feature dimension (must match every source matrix)
//
// Returns 0 on success, <0 on the first failing chunk.
int xta_materialize(int64_t n, const char** paths, const int64_t* offsets,
                    const int32_t* row_begin, const int32_t* lengths,
                    const int32_t* out_index, uint16_t* out,
                    int64_t pad_len, int64_t feat_dim) {
  int status = 0;
#ifdef _OPENMP
#pragma omp parallel
#endif
  {
    // per-thread decoded-matrix cache keyed by (path, offset)
    std::unordered_map<std::string, Matrix> cache;
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 4)
#endif
    for (int64_t i = 0; i < n; ++i) {
      int snapshot = 0;
#ifdef _OPENMP
#pragma omp atomic read
#endif
      snapshot = status;
      if (snapshot) continue;
      // first-observed failure wins; the critical section both orders
      // the write and keeps the report stable (a plain write raced the
      // reads above)
#ifdef _OPENMP
#define XTA_FAIL(code)                                                  \
  _Pragma("omp critical(xta_status)") { if (status == 0) status = (code); }
#else
#define XTA_FAIL(code) { if (status == 0) status = (code); }
#endif
      std::string key = std::string(paths[i]) + ":" +
                        std::to_string(offsets[i]);
      auto it = cache.find(key);
      if (it == cache.end()) {
        if (cache.size() > 64) cache.clear();
        Matrix m;
        if (read_mat_at(paths[i], offsets[i], &m)) {
          XTA_FAIL((int)(-100 - i));
          continue;
        }
        it = cache.emplace(std::move(key), std::move(m)).first;
      }
      const Matrix& m = it->second;
      if (m.cols != feat_dim || row_begin[i] + lengths[i] > m.rows) {
        XTA_FAIL((int)(-200 - i));
        continue;
      }
#undef XTA_FAIL
      uint16_t* dst = out + (size_t)out_index[i] * pad_len * feat_dim;
      const float* src =
          m.data.data() + (size_t)row_begin[i] * feat_dim;
      for (int64_t r = 0; r < lengths[i]; ++r)
        for (int64_t c = 0; c < feat_dim; ++c)
          dst[r * feat_dim + c] = f32_to_f16(src[r * feat_dim + c]);
    }
  }
  return status;
}

// ---------------------------------------------------------------------------
// Sequential ark stream: key<space>\0B<matrix> entries, decoded one by one.
// ---------------------------------------------------------------------------

struct XtaStream {
  std::FILE* f = nullptr;
  Matrix cur;          // decoded payload (CM only)
  char fmt = 0;        // 'F' (float), 'D' (double), 'C' (compressed)
  int32_t rows = 0, cols = 0;
  bool pending = false;  // FM/DM payload not yet consumed from the stream
};

// Open a binary ark for sequential reading.  Returns nullptr on failure.
void* xta_stream_open(const char* path) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  XtaStream* s = new XtaStream;
  s->f = f;
  // larger stdio buffer: ark payloads are ~100 KB sequential reads
  std::setvbuf(f, nullptr, _IOFBF, 1 << 20);
  return s;
}

// Same, over an already-open file descriptor (a pipe's read end, a
// socket, stdin).  The fd is dup()ed so the caller's handle stays
// independent; covers the reference's piped extraction input
// (extract_xvectors.sh:68) without a temp file.
void* xta_stream_open_fd(int fd) {
  int owned = dup(fd);
  if (owned < 0) return nullptr;
  std::FILE* f = fdopen(owned, "rb");
  if (!f) {
    close(owned);   // don't leak the dup'd descriptor
    return nullptr;
  }
  XtaStream* s = new XtaStream;
  s->f = f;
  std::setvbuf(f, nullptr, _IOFBF, 1 << 20);
  return s;
}

// Advance to the next entry.  Writes the NUL-terminated key (capacity
// key_cap) and the matrix dims.  FM/DM payloads are left in the stream and
// decoded straight into the caller's buffer by xta_stream_data (single
// copy); CM needs its column-major percentile decode, done here into a
// scratch matrix.  Returns 0 on success, 1 at EOF, <0 on a malformed
// entry.
int xta_stream_next(void* handle, char* key, int64_t key_cap, int32_t* rows,
                    int32_t* cols) {
  XtaStream* s = static_cast<XtaStream*>(handle);
  if (s->pending) {  // caller skipped the previous payload
    const int64_t bytes =
        (int64_t)s->rows * s->cols * (s->fmt == 'D' ? 8 : 4);
    if (skip_bytes(s->f, bytes)) return -8;  // pipe-safe, no fseek
    s->pending = false;
  }
  // getc_unlocked: handles are never shared across threads, and the
  // per-char lock in fgetc dominates key scans on many-small-entry arks
  int64_t n = 0;
  int ch = getc_unlocked(s->f);
  if (ch == EOF) return 1;
  while (ch != EOF && ch != ' ') {
    if (n + 1 >= key_cap) return -4;
    key[n++] = (char)ch;
    ch = getc_unlocked(s->f);
  }
  if (ch == EOF || n == 0) return -5;
  key[n] = '\0';
  char head[5];  // \0B marker + 3-byte format tag in one read
  if (read_exact(s->f, head, 5) || head[0] != '\0' || head[1] != 'B')
    return -6;
  const char* hdr = head + 2;
  if (!std::memcmp(hdr, "FM ", 3) || !std::memcmp(hdr, "DM ", 3)) {
    unsigned char dims[10];  // (size byte + int32) x 2
    if (read_exact(s->f, dims, 10) || dims[0] != 4 || dims[5] != 4)
      return -7;
    std::memcpy(&s->rows, dims + 1, 4);
    std::memcpy(&s->cols, dims + 6, 4);
    if (!dims_ok(s->rows, s->cols)) return -7;
    s->fmt = hdr[0];
    s->pending = true;
  } else if (!std::memcmp(hdr, "FV ", 3) || !std::memcmp(hdr, "DV ", 3)) {
    // float/double vector entry, exposed as a 1 x dim matrix
    unsigned char dimbuf[5];
    if (read_exact(s->f, dimbuf, 5) || dimbuf[0] != 4) return -7;
    int32_t dim;
    std::memcpy(&dim, dimbuf + 1, 4);
    if (!dims_ok(1, dim) || dim > (1 << 28)) return -7;
    s->rows = 1;
    s->cols = dim;
    s->fmt = hdr[0];
    s->pending = true;
  } else if (!std::memcmp(hdr, "CM", 2)) {   // CM , CM2, CM3
    if (decode_mat_body(s->f, hdr, &s->cur)) return -7;
    s->fmt = 'C';
    s->rows = s->cur.rows;
    s->cols = s->cur.cols;
  } else {
    return -2;
  }
  *rows = s->rows;
  *cols = s->cols;
  return 0;
}

// Write the current entry's payload into a caller buffer of cap floats.
int xta_stream_data(void* handle, float* out, int64_t cap) {
  XtaStream* s = static_cast<XtaStream*>(handle);
  const int64_t count = (int64_t)s->rows * s->cols;
  if (count > cap) return -3;
  if (s->fmt == 'F') {
    if (!s->pending) return -9;
    s->pending = false;
    return read_exact(s->f, out, (size_t)count * 4);
  }
  if (s->fmt == 'D') {
    if (!s->pending) return -9;
    s->pending = false;
    std::vector<double> tmp((size_t)count);
    if (read_exact(s->f, tmp.data(), tmp.size() * 8)) return -1;
    for (int64_t i = 0; i < count; ++i) out[i] = (float)tmp[i];
    return 0;
  }
  std::memcpy(out, s->cur.data.data(), (size_t)count * 4);
  return 0;
}

// Bulk-decode consecutive same-dim vector (FV/DV or 1-row FM/DM) entries
// into a caller float32 buffer (rows packed contiguously at the true
// dim) + one newline-separated key blob (*keys_used gets its length).
// dim is inferred from the first entry and returned via *dim_out.  Stops
// at EOF or max_rows; a ragged dim is an error (-11).  Returns rows
// decoded, or <0 on a malformed entry.  One ctypes crossing for a whole
// ark — the per-entry Python/C boundary is what dominates small-entry
// reads.
int64_t xta_stream_read_vecs(void* handle, float* out, int64_t cap_floats,
                             char* keys, int64_t keys_cap,
                             int64_t max_rows, int32_t* dim_out,
                             int64_t* keys_used) {
  int64_t rows = 0, kpos = 0;
  int32_t dim = -1;
  char key[1024];
  while (rows < max_rows) {
    int32_t r, c;
    int rc = xta_stream_next(handle, key, sizeof(key), &r, &c);
    if (rc == 1) break;           // EOF
    if (rc) return rc < 0 ? rc : -1;
    int64_t n = (int64_t)r * c;
    if (r != 1 && c != 1) return -10;     // not a vector
    if (dim < 0) dim = (int32_t)n;
    if (n != dim) return -11;             // ragged dims
    if ((rows + 1) * (int64_t)dim > cap_floats) return -13;  // overflow
    // keys go into ONE newline-separated blob: Python recovers them all
    // with a single split instead of a per-key slice+decode
    int64_t klen = (int64_t)std::strlen(key);
    if (kpos + klen + 1 > keys_cap) return -14;
    std::memcpy(keys + kpos, key, klen);
    keys[kpos + klen] = '\n';
    kpos += klen + 1;
    rc = xta_stream_data(handle, out + rows * dim, dim);
    if (rc) return -12;
    ++rows;
  }
  *dim_out = dim;
  *keys_used = kpos;
  return rows;
}

void xta_stream_close(void* handle) {
  XtaStream* s = static_cast<XtaStream*>(handle);
  if (s->f) std::fclose(s->f);
  delete s;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// shorten (v0-v2) decoder — the embedded-shorten payload of LDC SPHERE
// files (sample_coding "pcm,embedded-shorten-v2.00" etc.).  This is the
// production twin of the pure-Python decoder in io/shorten.py (kept
// bit-identical; see tests/test_torch_native.py parity cases).  Replaces
// the reference recipe's reliance on the external sph2pipe binary
// (SURVEY.md K1; e.g. local/make_sre16_eval_BUT.pl:53).
// ---------------------------------------------------------------------------

namespace shn {

constexpr int kUlongSize = 2, kLpcqSize = 2, kLpcQuant = 5, kXByteSize = 7;
constexpr int kEnergySize = 3, kBitshiftSize = 2, kFnSize = 2;
constexpr int kTypeSize = 4, kChanSize = 0, kNSkipSize = 1;
constexpr int kVerbCkSize = 5, kVerbByteSize = 8, kNWrap = 3;
constexpr int kBlocksizeLog2 = 8;  // log2(DEFAULT_BLOCK_SIZE 256)

enum Fn { DIFF0 = 0, DIFF1, DIFF2, DIFF3, QUIT, BLOCKSIZE, BITSHIFT,
          QLPC, ZERO, VERBATIM };
enum Type { AU1 = 0, S8, U8, S16HL, U16HL, S16LH, U16LH, ULAW, AU2, AU3,
            ALAW };

struct BitReader {
  const uint8_t* p;
  int64_t len, pos = 0;       // byte position
  uint32_t cur = 0;
  int nbit = 0;
  bool overrun = false;

  void refill() {
    uint32_t w = 0;
    for (int i = 0; i < 4; ++i) {
      w = (w << 8) | (pos < len ? p[pos] : 0);
      if (pos >= len + 4) overrun = true;  // well past the end: corrupt
      ++pos;
    }
    cur = w;
    nbit = 32;
  }
  inline int bit() {
    if (nbit == 0) refill();
    return (cur >> --nbit) & 1;
  }
  inline int64_t uvar(int k) {
    int64_t q = 0;
    while (!bit()) {
      if (overrun || q > 1 << 20) { overrun = true; return 0; }
      ++q;
    }
    int64_t v = q;
    for (int i = 0; i < k; ++i) v = (v << 1) | bit();
    return v;
  }
  inline int64_t svar(int k) {
    int64_t u = uvar(k + 1);
    return (u & 1) ? ~(u >> 1) : (u >> 1);
  }
  inline int64_t ulong_() { return uvar((int)uvar(kUlongSize)); }
};

inline int64_t cdiv(int64_t a, int64_t b) { return a / b; }  // C trunc
inline int64_t rshift_round(int64_t x, int n) {
  return n == 0 ? x : ((x >> (n - 1)) + 1) >> 1;
}

struct Header {
  int version = 0, ftype = 0, nchan = 0;
  int64_t blocksize = 0, maxnlpc = 0, nmean = 0;
};

// Parse magic + header fields; leaves br positioned after the skip bytes.
static int parse_header(const uint8_t* data, int64_t len, BitReader* br,
                        Header* h) {
  if (len < 5 || std::memcmp(data, "ajkg", 4)) return -1;
  h->version = data[4];
  if (h->version > 2) return -2;
  br->p = data + 5;
  br->len = len - 5;
  auto uint_get = [&](int k) {
    return h->version == 0 ? br->uvar(k) : br->ulong_();
  };
  h->ftype = (int)uint_get(kTypeSize);
  h->nchan = (int)uint_get(kChanSize);
  h->blocksize = uint_get(kBlocksizeLog2);
  h->maxnlpc = uint_get(kLpcqSize);
  h->nmean = uint_get(0);
  int64_t nskip = uint_get(kNSkipSize);
  for (int64_t i = 0; i < nskip; ++i) br->uvar(kXByteSize);
  if (br->overrun || h->nchan < 1 || h->nchan > 8 || h->blocksize < 1 ||
      h->blocksize > (1 << 20) || h->maxnlpc < 0 || h->maxnlpc > 1024)
    return -3;
  switch (h->ftype) {
    case S8: case U8: case S16HL: case U16HL: case S16LH: case U16LH:
    case ULAW: case ALAW:
      return 0;
    default:
      return -4;  // AU1/AU2/AU3 (internal ulaw mapping) unsupported
  }
}

}  // namespace shn

extern "C" {

// Header-only probe.  Returns 0 and fills nchan/ftype, or <0 on error.
int xta_shorten_probe(const char* data, int64_t len, int32_t* nchan,
                      int32_t* ftype) {
  shn::BitReader br;
  shn::Header h;
  int rc = shn::parse_header((const uint8_t*)data, len, &br, &h);
  if (rc) return rc;
  *nchan = h.nchan;
  *ftype = h.ftype;
  return 0;
}

// Full decode into out (cap rows x nchan, int32, channel-interleaved).
// Returns the number of complete per-channel rows produced, or <0.
int64_t xta_shorten_decode(const char* data, int64_t len, int32_t* out,
                           int64_t cap) {
  using namespace shn;
  BitReader br;
  Header h;
  int rc = parse_header((const uint8_t*)data, len, &br, &h);
  if (rc) return rc;
  const int64_t lpcqoffset = h.version >= 2 ? (1 << kLpcQuant) : 0;
  const int64_t type_mean =
      h.ftype == U8 ? 0x80 :
      (h.ftype == U16HL || h.ftype == U16LH) ? 0x8000 : 0;
  const int nchan = h.nchan;
  const int64_t nwrap = std::max<int64_t>(kNWrap, h.maxnlpc);
  int64_t blocksize = h.blocksize;
  const int64_t nmean_w = std::max<int64_t>(1, h.nmean);

  // per-channel state: [history nwrap | block buffer], mean window
  std::vector<std::vector<int64_t>> buf(
      nchan, std::vector<int64_t>(nwrap + blocksize, 0));
  std::vector<std::vector<int64_t>> offset(
      nchan, std::vector<int64_t>(nmean_w, type_mean));
  // sized to nwrap, NOT maxnlpc: FN_QLPC's own nlpc is only validated
  // against nwrap below, and a crafted stream may declare maxnlpc=0 yet
  // emit nlpc=3 (heap overflow otherwise)
  std::vector<int64_t> qlpc(nwrap);
  std::vector<int64_t> written(nchan, 0);  // rows emitted per channel
  int bitshift = 0;
  int chan = 0;

  while (true) {
    if (br.overrun) return -5;
    int64_t cmd = br.uvar(kFnSize);
    if (cmd == QUIT) break;
    switch (cmd) {
      case BLOCKSIZE: {
        int64_t nb = h.version == 0 ? br.uvar(kBlocksizeLog2)
                                    : br.ulong_();
        if (nb < 1 || nb > (1 << 20)) return -6;
        if (nb > blocksize)
          for (auto& b : buf) b.resize(nwrap + nb);
        blocksize = nb;
        continue;
      }
      case BITSHIFT:
        bitshift = (int)br.uvar(kBitshiftSize);
        if (bitshift < 0 || bitshift > 31) return -15;  // UB shift guard
        continue;
      case VERBATIM: {
        int64_t n = br.uvar(kVerbCkSize);
        for (int64_t i = 0; i < n; ++i) br.uvar(kVerbByteSize);
        continue;
      }
      case ZERO: case DIFF0: case DIFF1: case DIFF2: case DIFF3:
      case QLPC:
        break;
      default:
        return -7;
    }

    int resn = 0;
    if (cmd != ZERO) {
      resn = (int)br.uvar(kEnergySize);
      if (h.version == 0) resn -= 1;
      if (resn < 0 || resn > 48) return -16;  // residual width guard
    }
    auto& off = offset[chan];
    int64_t coffset;
    if (h.nmean == 0) {
      coffset = off[0];
    } else {
      int64_t s = h.version >= 2 ? h.nmean / 2 : 0;
      for (int64_t i = 0; i < h.nmean; ++i) s += off[i];
      coffset = h.version < 2 ? cdiv(s, h.nmean)
                              : rshift_round(cdiv(s, h.nmean), bitshift);
    }
    int64_t* b = buf[chan].data() + nwrap;   // block region; b[-i] = history
    switch (cmd) {
      case ZERO:
        for (int64_t i = 0; i < blocksize; ++i) b[i] = 0;
        break;
      case DIFF0:
        for (int64_t i = 0; i < blocksize; ++i)
          b[i] = br.svar(resn) + coffset;
        break;
      case DIFF1:
        for (int64_t i = 0; i < blocksize; ++i)
          b[i] = br.svar(resn) + b[i - 1];
        break;
      case DIFF2:
        for (int64_t i = 0; i < blocksize; ++i)
          b[i] = br.svar(resn) + 2 * b[i - 1] - b[i - 2];
        break;
      case DIFF3:
        for (int64_t i = 0; i < blocksize; ++i)
          b[i] = br.svar(resn) + 3 * b[i - 1] - 3 * b[i - 2] + b[i - 3];
        break;
      case QLPC: {
        int64_t nlpc = br.uvar(kLpcqSize);
        if (nlpc < 0 || nlpc > nwrap) return -8;
        for (int64_t j = 0; j < nlpc; ++j) qlpc[j] = br.svar(kLpcQuant);
        for (int64_t j = 1; j <= nlpc; ++j) b[-j] -= coffset;
        for (int64_t i = 0; i < blocksize; ++i) {
          int64_t s = lpcqoffset;
          for (int64_t j = 0; j < nlpc; ++j) s += qlpc[j] * b[i - j - 1];
          b[i] = br.svar(resn) + (s >> kLpcQuant);
        }
        if (coffset != 0)
          for (int64_t i = -nlpc; i < blocksize; ++i) b[i] += coffset;
        break;
      }
    }
    if (br.overrun) return -5;
    if (h.nmean > 0) {
      int64_t s = h.version >= 2 ? blocksize / 2 : 0;
      for (int64_t i = 0; i < blocksize; ++i) s += b[i];
      for (int64_t i = 1; i < h.nmean; ++i) off[i - 1] = off[i];
      int64_t m = cdiv(s, blocksize);
      off[h.nmean - 1] = h.version >= 2 ? (m << bitshift) : m;
    }
    // wrap pre-bitshift values into the history region:
    // new_hist = (old_hist ++ block)[-nwrap:]
    for (int64_t i = 0; i < nwrap; ++i) {
      int64_t src = blocksize - nwrap + i;
      buf[chan][i] = src >= 0 ? b[src] : buf[chan][i + blocksize];
    }
    // emit (bitshift applies to output only)
    int64_t row = written[chan];
    int64_t n_emit = std::max<int64_t>(0, std::min(blocksize, cap - row));
    for (int64_t i = 0; i < n_emit; ++i)
      out[(row + i) * nchan + chan] = (int32_t)(b[i] << bitshift);
    written[chan] = row + blocksize;
    chan = (chan + 1) % nchan;
    // stop once every channel has filled the caller's capacity
    bool full = true;
    for (int c = 0; c < nchan; ++c) full = full && written[c] >= cap;
    if (full) break;
  }
  int64_t rows = written[0];
  for (int c = 1; c < nchan; ++c) rows = std::min(rows, written[c]);
  return std::min(rows, cap);
}

int xta_version() { return 3; }

// Threads xta_materialize fans out to: OpenMP's count, or 1 in a build
// without OpenMP (a toolchain without libgomp).
int xta_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
