// Sliding-window CMVN (Kaldi apply-cmvn-sliding) of one utterance's (T, D)
// f32 features, row-major, and in the same pass voiced-frame selection
// (select-voiced-frames):
//
//   s(t)   = clamp(t - off, 0, T - win)          off = win/2 centred,
//                                                 win - 1 trailing
//   mean   = f32(sum_{r in [s, s+win)} x[r] / win)      sum in f64
//   y[t]   = x[t] - mean
//   norm_vars: var = f32(sum f64(f32(x[r]^2)) / win) - mean*mean (f32),
//              y[t] = (x[t] - mean) * (1 / sqrt(max(var, 1e-10)))
//   out[dest[t]] = y[t]  where 0 <= dest[t] < rows; frame t dropped else
//
// with win = min(window, T): the window keeps win frames and slides rather
// than shrinks at the edges.  The destination map dest (int32, one entry a
// frame) gives each frame's row in the (rows, D) output, -1 for a frame
// that is dropped; the host builds it from the VAD with a prefix count of
// the voiced frames, so it knows the output's rows without asking the card.
// Without a map (a null pointer) frame t goes to row t.  The window sums
// run over all T frames, voiced or not, as Kaldi's pipe applies CMVN before
// it selects.  Every f32 step rounds as ops/features.py's plain version
// (sliding_cmvn on a CPU tensor, then the boolean selection) does; only the
// f64 window sums are taken in another order.
//
// Replaces no TPU kernel: the JAX package takes these window sums with
// lax.reduce_window (xvector_tpu/ops/features.py _window_sums).  The
// plain version's f64 prefix sum along the frames runs on the card as
// PyTorch's outer-dim scan, one thread per column walking all T rows
// (~1.6 ms at T = 8,526, D = 23): most of extraction's device time.
//
// What bounds it on this card: bytes, T·D·4 in, T·4 of map, rows·D·4 out
// (0.2 us at T = 8,526, D = 23 at 3.35 TB/s), so in practice the launch and
// the first window's f64 adds.  What the design does: a block owns TILE
// consecutive input frames by up to COLS columns and copies the rows its
// windows span (at most TILE - 1 + win) into shared memory once, coalesced
// along D, by cp.async.  Thread (column c, run r) owns RUN consecutive
// frames: it sums its first window directly from shared memory in f64
// (four partial sums), then slides, since the clamped start moves by 0 or 1
// a frame: one row in, one row out.  Direct f64 sums over win rows are at
// least as exact as the plain version's differences of a prefix sum over T
// rows.  A frame's map entry is one word that the 32 threads of its warp
// read together; each kept output is written once, coalesced along D, to
// its row, so selection costs no pass and no copy of its own.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;              // frames per block
constexpr int RUNS = 8;               // frame runs per block (blockDim.y)
constexpr int RUN = TILE / RUNS;      // frames per thread
constexpr int COLS = 32;              // columns per block at most (blockDim.x)
constexpr int SMEM_MAX = 232448;      // a block's shared memory on sm_90
constexpr int SMEM_DEFAULT = 48 * 1024;

__device__ __forceinline__ int window_start(int t, int off, int last) {
  const int s = t - off;
  return s < 0 ? 0 : (s > last ? last : s);
}

template <bool NORM_VARS>
__global__ void __launch_bounds__(COLS * RUNS)
sliding_cmvn_kernel(const float* __restrict__ x,
                    const int* __restrict__ dest, float* __restrict__ out,
                    int T, int D, int win, int off, int rows_out, int cols) {
  extern __shared__ float tile[];     // [rows][nc]
  const int t0 = blockIdx.x * TILE;
  const int c0 = blockIdx.y * cols;
  const int nc = min(cols, D - c0);
  const int last = T - win;
  const int t1 = min(t0 + TILE, T);
  const int row0 = window_start(t0, off, last);
  const int rows = window_start(t1 - 1, off, last) + win - row0;
  // the rows, as 4-byte cp.async copies all in flight at once (a plain
  // load-then-store loop waits out the device memory's latency each pass)
  for (int i = threadIdx.y * COLS + threadIdx.x; i < rows * nc;
       i += COLS * RUNS) {
    const int r = i / nc;
    const float* src =
        x + static_cast<size_t>(row0 + r) * D + c0 + (i - r * nc);
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(tile + i));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int c = threadIdx.x;
  const int f0 = t0 + threadIdx.y * RUN;
  if (c >= nc || f0 >= T) return;
  // tile[at(r)] is row r (an utterance frame) of this thread's column
  auto at = [&](int r) { return (r - row0) * nc + c; };
  int s = window_start(f0, off, last);

  double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
  double q0 = 0.0, q1 = 0.0, q2 = 0.0, q3 = 0.0;
  int i = 0;
  for (; i + 4 <= win; i += 4) {
    const float v0 = tile[at(s + i)], v1 = tile[at(s + i + 1)];
    const float v2 = tile[at(s + i + 2)], v3 = tile[at(s + i + 3)];
    a0 += v0;
    a1 += v1;
    a2 += v2;
    a3 += v3;
    if constexpr (NORM_VARS) {
      q0 += __fmul_rn(v0, v0);
      q1 += __fmul_rn(v1, v1);
      q2 += __fmul_rn(v2, v2);
      q3 += __fmul_rn(v3, v3);
    }
  }
  for (; i < win; ++i) {
    const float v = tile[at(s + i)];
    a0 += v;
    if constexpr (NORM_VARS) q0 += __fmul_rn(v, v);
  }
  double sum = (a0 + a1) + (a2 + a3);
  double sq = (q0 + q1) + (q2 + q3);

  const int f1 = min(f0 + RUN, T);
  for (int t = f0; t < f1; ++t) {
    const int st = window_start(t, off, last);
    if (st != s) {                    // st == s + 1: one row in, one out
      const float vin = tile[at(s + win)];
      const float vout = tile[at(s)];
      sum += vin;
      sum -= vout;
      if constexpr (NORM_VARS) {
        sq += __fmul_rn(vin, vin);
        sq -= __fmul_rn(vout, vout);
      }
      s = st;
    }
    const int row = dest == nullptr ? t : __ldg(dest + t);
    if (row < 0 || row >= rows_out) continue;   // dropped: not voiced
    const float mean = static_cast<float>(sum / win);
    float y = __fsub_rn(tile[at(t)], mean);
    if constexpr (NORM_VARS) {
      float var = __fsub_rn(static_cast<float>(sq / win),
                            __fmul_rn(mean, mean));
      var = var < 1e-10f ? 1e-10f : var;   // a NaN stays NaN, as torch.clamp
      y = __fmul_rn(y, __fdiv_rn(1.0f, __fsqrt_rn(var)));
    }
    out[static_cast<size_t>(row) * D + c0 + c] = y;
  }
}

template <bool NORM_VARS>
int launch(const float* x, const int* dest, float* out, int T, int D,
           int win, int off, int rows_out, cudaStream_t stream) {
  const int rows = min(T, TILE - 1 + win);
  int cols = min(min(D, COLS), SMEM_MAX / (rows * 4));
  if (cols < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int ytiles = (D + cols - 1) / cols;
  if (ytiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cols = (D + ytiles - 1) / ytiles;   // even column tiles: 80 -> 27, 27, 26
  const int smem = rows * cols * 4;
  auto kern = sliding_cmvn_kernel<NORM_VARS>;
  if (smem > SMEM_DEFAULT) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((T + TILE - 1) / TILE, ytiles);
  kern<<<grid, dim3(COLS, RUNS), smem, stream>>>(x, dest, out, T, D, win,
                                                   off, rows_out, cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out = sliding CMVN of x, its frames selected by dest: x (T, D) and out
// (rows, D) f32 row-major on the device, dest int32 (T,) on the device or
// null (every frame t to row t: rows = T).  Returns a cudaError_t:
// cudaErrorInvalidValue, with nothing launched, unless 1 <= win <= T,
// 0 <= off < win, rows >= 1 (rows = T without a map) and
// min(T, TILE - 1 + win) f32 rows fit in a block's shared memory.  Map
// entries outside [0, rows) drop their frame.
int sliding_cmvn_launch(const void* x, const void* dest, void* out, int T,
                        int D, int win, int off, int rows, int norm_vars,
                        void* stream) {
  if (T < 1 || D < 1 || win < 1 || win > T || off < 0 || off >= win ||
      rows < 1 || (dest == nullptr && rows != T))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const int* map = static_cast<const int*>(dest);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return norm_vars ? launch<true>(xf, map, of, T, D, win, off, rows, s)
                   : launch<false>(xf, map, of, T, D, win, off, rows, s);
}

}  // extern "C"
