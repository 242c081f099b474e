// SAME 1-D convolution of the wide TDNN layers for Hopper (sm_90a): the
// forward, the weight gradient and the input gradient of one layer.
//
// Replaces the TPU kernels of xvector_tpu/ops/conv_bwd.py, the three
// Pallas calls behind its custom VJP conv1d_same_fused_bwd:
//
//   K2 _pallas_fwd (_fwd_kernel):  y[b,t]  = sum_j x[b, t - left + j*d] W[j]
//   K3 _pallas_dw  (_dw_kernel):   dW[j]   = sum_{b,t} x[b, t - left + j*d]^T g[b,t]
//   K4 _pallas_dx  (_dx_kernel):   dx[b,t] = sum_j g[b, t + left - j*d] W[j]^T
//
// with x (B, T, Cin), W (K, Cin, Cout), g (B, T, Cout), left = (K-1)/2*d,
// and zeros outside [0, T) of each batch row.  Operands are bf16; every
// product of a call accumulates in f32 and is rounded once: y and dx to
// bf16, dW stays f32 (the caller casts it to the weight dtype).
//
// What bounds them on this card: operations.  At the training working
// point (64 x 304 frames, 512 -> 512 channels) a k=5 call is 5.1e10 FLOP
// against ~43 MB of compulsory traffic (~1200 FLOP/byte), k=7 7.1e10 FLOP
// against ~44 MB, far above the H100's ~295 FLOP/byte balance in bf16.
//
// What the design does about it: every product runs on the tensor cores
// (mma.sync m16n8k16, bf16 fragments from ldmatrix, f32 accumulators in
// registers) with the operand loads off the critical path: a block owns a
// 128 x 128 output tile (8 warps of 64 x 32) and streams 64-deep slices of
// both operands through a 3-stage cp.async ring.  The k shifted products
// are never unfolded in device memory: the shift is in the load address.
//
// * K2 and K4 are one implicit GEMM over the flattened (b, t) rows.  The
//   contraction runs over (tap j, channel) jointly in W's row order; an A
//   column (j, c) is channel c of the rows shifted by off + sgn*j*d (K2:
//   -left + j*d; K4: +left - j*d), masked to the row's own [0, T), so a
//   tile may span batch rows without reading a neighbour's frames.  K4
//   reads W[j] transposed: its tiles are staged (Cin, Cout-slice) as they
//   lie in memory and fed to the tensor cores as column-major fragments.
// * K3 contracts over the B*T rows, which leaves few output tiles (80 for
//   k=5, 112 for k=7 at 512 channels, fewer than the card's 132 SMs x 2).
//   The rows are split into `splits` contiguous ranges; each block writes
//   its partial tile to an f32 workspace and a second pass sums the
//   partials in split order.  Deterministic: the same inputs give the same
//   bits on every run.  Both operands are contracted along their row axis,
//   so A (x, staged rows x channels) goes through ldmatrix.trans.  A K3
//   call is two CUDA launches (one when splits == 1); the wrappers count it
//   as one call.
//
// Shapes need not be tile multiples: ragged B*T, Cin and Cout take
// predicated loads and stores, and channel counts that are not multiples
// of 8 take scalar loads into the same ring.  wgmma and TMA in place of
// mma.sync and cp.async are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "mma_sm80.cuh"

namespace {

constexpr int BM = 128;        // output rows per block
constexpr int BN = 128;        // output columns per block
constexpr int BK = 64;         // contraction depth per pipeline step
constexpr int STAGES = 3;      // cp.async ring depth
constexpr int THREADS = 256;   // 8 warps: 2 along rows x 4 along columns
constexpr int LDK = BK + 8;    // tiles stored contraction-minor: 144 B rows
constexpr int LDN = BN + 8;    // tiles stored column-minor: 272 B rows
constexpr int LDM = BM + 8;
constexpr int A_ROWS = 4;      // A rows each thread stages per step (vector)
// shifted GEMM: A (BM x LDK) + B (BK x LDN or BN x LDK, whichever is larger)
constexpr int SH_A = BM * LDK;
constexpr int SH_B = BN * LDK > BK * LDN ? BN * LDK : BK * LDN;
constexpr size_t SH_SMEM =
    static_cast<size_t>(STAGES) * (SH_A + SH_B) * sizeof(bf16);
// weight gradient: A (BK x LDM) + B (BK x LDN)
constexpr int DW_A = BK * LDM;
constexpr int DW_B = BK * LDN;
constexpr size_t DW_SMEM =
    static_cast<size_t>(STAGES) * (DW_A + DW_B) * sizeof(bf16);
static_assert(THREADS / (BK / 8) * A_ROWS == BM, "A vector staging");
static_assert(THREADS % BN == 0 && THREADS % BK == 0, "scalar staging");

// ---------------------------------------------------------------------------
// K2 / K4: out[r, n] = sum_{(j,c)} a[r + off + sgn*j*dil, c] * Wv[(j,c), n]
// over flattened rows r = b*T + t.  WT = false (K2): Wv[(j,c), n] =
// w[j][c][n].  WT = true (K4): Wv[(j,c), n] = w[j][n][c].
// ---------------------------------------------------------------------------

struct ShiftArgs {
  const bf16* a;   // (B*T, Ca)
  const bf16* w;   // (K, Ca, N) or, WT, (K, N, Ca)
  bf16* out;       // (B*T, N)
  int rows, T, Ca, N, K, dil, off, sgn;
};

template <bool WT>
__device__ __forceinline__ void shift_load_step(const ShiftArgs& a, bf16* sA,
                                                bf16* sB, int step, int m0,
                                                int n0, const int* row_t) {
  const int kc0 = step * BK;
  const int kc_end = a.K * a.Ca;
  const int tid = threadIdx.x;

  // A: rows [m0, m0 + BM) x contraction [kc0, kc0 + BK), stored [m][k]
  if ((a.Ca % 8) == 0) {
    const int v = tid % (BK / 8), kc = kc0 + v * 8;
    const int j = kc / a.Ca, c = kc - j * a.Ca;
    const int shift = a.off + a.sgn * j * a.dil;
#pragma unroll
    for (int i = 0; i < A_ROWS; ++i) {
      const int r = tid / (BK / 8) + i * (THREADS / (BK / 8));
      const int t = row_t[i] + shift;
      const bool ok = kc < kc_end && t >= 0 && t < a.T;
      cp_async16(sA + r * LDK + v * 8,
                 ok ? static_cast<const void*>(
                          a.a + static_cast<size_t>(m0 + r + shift) * a.Ca + c)
                    : static_cast<const void*>(a.a),
                 ok);
    }
  } else {
    const int cc = tid % BK, kc = kc0 + cc;
    const int j = kc / a.Ca, c = kc - j * a.Ca;
    const int shift = a.off + a.sgn * j * a.dil;
    for (int r = tid / BK; r < BM; r += THREADS / BK) {
      const int row = m0 + r;
      const int t = row - (row / a.T) * a.T + shift;
      const bool ok = kc < kc_end && row < a.rows && t >= 0 && t < a.T;
      sA[r * LDK + cc] =
          ok ? a.a[static_cast<size_t>(row + shift) * a.Ca + c]
             : __float2bfloat16(0.0f);
    }
  }

  if (!WT) {
    // B: W rows [kc0, kc0 + BK) of (K * Ca, N), columns [n0, n0 + BN),
    // stored [k][n] as they lie in memory
    if ((a.N % 8) == 0) {
      const int v = tid % (BN / 8), n = n0 + v * 8;
      for (int cc = tid / (BN / 8); cc < BK; cc += THREADS / (BN / 8)) {
        const int kc = kc0 + cc;
        const bool ok = kc < kc_end && n < a.N;
        cp_async16(sB + cc * LDN + v * 8,
                   ok ? static_cast<const void*>(
                            a.w + static_cast<size_t>(kc) * a.N + n)
                      : static_cast<const void*>(a.w),
                   ok);
      }
    } else {
      const int nn = tid % BN, n = n0 + nn;
      for (int cc = tid / BN; cc < BK; cc += THREADS / BN) {
        const int kc = kc0 + cc;
        sB[cc * LDN + nn] = (kc < kc_end && n < a.N)
                                ? a.w[static_cast<size_t>(kc) * a.N + n]
                                : __float2bfloat16(0.0f);
      }
    }
  } else {
    // B: w[j][n][c] for columns [n0, n0 + BN) and contraction (j, c) in
    // [kc0, kc0 + BK), stored [n][k]: 8 consecutive c of one n are one
    // 16-byte vector in memory and one ldmatrix row
    if ((a.Ca % 8) == 0) {
      const int v = tid % (BK / 8), kc = kc0 + v * 8;
      const int j = kc / a.Ca, c = kc - j * a.Ca;
      for (int nn = tid / (BK / 8); nn < BN; nn += THREADS / (BK / 8)) {
        const int n = n0 + nn;
        const bool ok = kc < kc_end && n < a.N;
        cp_async16(sB + nn * LDK + v * 8,
                   ok ? static_cast<const void*>(
                            a.w + (static_cast<size_t>(j) * a.N + n) * a.Ca +
                            c)
                      : static_cast<const void*>(a.w),
                   ok);
      }
    } else {
      const int cc = tid % BK, kc = kc0 + cc;
      const int j = kc / a.Ca, c = kc - j * a.Ca;
      for (int nn = tid / BK; nn < BN; nn += THREADS / BK) {
        const int n = n0 + nn;
        sB[nn * LDK + cc] =
            (kc < kc_end && n < a.N)
                ? a.w[(static_cast<size_t>(j) * a.N + n) * a.Ca + c]
                : __float2bfloat16(0.0f);
      }
    }
  }
}

template <bool WT>
__global__ void __launch_bounds__(THREADS, 2) shift_gemm_kernel(ShiftArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4;   // 0..1: 64-row slice
  const int wn = warp % 4;   // 0..3: 32-column slice
  const int steps = (a.K * a.Ca + BK - 1) / BK;

  // frame index t of each A row this thread stages (vector path); rows
  // past the end get a t that no shift brings back into [0, T)
  int row_t[A_ROWS];
#pragma unroll
  for (int i = 0; i < A_ROWS; ++i) {
    const int row = m0 + threadIdx.x / (BK / 8) + i * (THREADS / (BK / 8));
    row_t[i] = row < a.rows ? row - (row / a.T) * a.T : -(1 << 29);
  }

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

  auto slot_a = [&](int s) { return ring + s * (SH_A + SH_B); };
  auto slot_b = [&](int s) { return ring + s * (SH_A + SH_B) + SH_A; };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps)
      shift_load_step<WT>(a, slot_a(s), slot_b(s), s, m0, n0, row_t);
    cp_async_commit();
  }

  // A as stored [m][k]: lane l feeds row l % 16, k offset (l / 16) * 8.
  const int lr = lane % 16, lc = (lane / 16) * 8;
  // B [k][n] (K2) through .trans: lane l feeds k row l % 16, n offset
  // (l / 16) * 8.  B [n][k] (K4) as stored: lane l feeds n row
  // (l / 16) * 8 + l % 8, k offset ((l / 8) & 1) * 8.
  const int tn = (lane / 16) * 8 + lane % 8, tk = ((lane / 8) & 1) * 8;
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // step's slot is filled; slot step-1 is free
    const int nxt = step + STAGES - 1;
    if (nxt < steps)
      shift_load_step<WT>(a, slot_a(nxt % STAGES), slot_b(nxt % STAGES), nxt,
                          m0, n0, row_t);
    cp_async_commit();

    const bf16* sA = slot_a(step % STAGES) + (wm * 64 + lr) * LDK + lc;
    const bf16* sB =
        WT ? slot_b(step % STAGES) + (wn * 32 + tn) * LDK + tk
           : slot_b(step % STAGES) + lr * LDN + wn * 32 + lc;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t fa[4][4], fb[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) ldsm_x4(fa[mi], sA + mi * 16 * LDK + kk);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {   // 16 columns = two n8 tiles
        uint32_t r[4];
        if (WT)
          ldsm_x4(r, sB + nj * 16 * LDK + kk);
        else
          ldsm_x4_trans(r, sB + kk * LDN + nj * 16);
        fb[2 * nj][0] = r[0];
        fb[2 * nj][1] = r[1];
        fb[2 * nj + 1][0] = r[2];
        fb[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], fa[mi], fb[ni]);
    }
  }
  cp_async_wait<0>();

  // Thread holds rows g and g+8 of each m16n8 tile, 2 adjacent columns.
  const bool pair_out = (a.N % 2) == 0;
  const int g = lane / 4, c2 = (lane % 4) * 2;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int n = n0 + wn * 32 + ni * 8 + c2;
    if (n >= a.N) continue;
    const bool two = n + 1 < a.N;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 64 + mi * 16 + g + h * 8;
        if (row >= a.rows) continue;
        bf16* dst = a.out + static_cast<size_t>(row) * a.N + n;
        const float* v = &acc[mi][ni][2 * h];
        if (pair_out && two) {
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(v[0], v[1]);
        } else {
          dst[0] = __float2bfloat16(v[0]);
          if (two) dst[1] = __float2bfloat16(v[1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K3: part[s][(j,ci), co] = sum over rows r of split s of
//     x[r - left + j*dil, ci] * g[r, co]   (shifted rows inside r's own
//     batch row only), then dW = sum_s part[s].
// ---------------------------------------------------------------------------

struct DwArgs {
  const bf16* x;   // (B*T, Cin)
  const bf16* g;   // (B*T, Cout)
  float* out;      // (splits, K*Cin, Cout) partials, or dW when splits == 1
  int rows, T, Cin, Cout, K, dil, left, split_rows;
};

__device__ __forceinline__ void dw_load_step(const DwArgs& a, bf16* sA,
                                             bf16* sB, int r0, int r_end,
                                             int m0, int n0) {
  const int tid = threadIdx.x;
  const int m_end = a.K * a.Cin;
  // A: contraction rows [r0, r0 + BK) x output rows (j, ci) in
  // [m0, m0 + BM), stored [k][m]
  if ((a.Cin % 8) == 0) {
    const int v = tid % (BM / 8), m = m0 + v * 8;
    const int j = m / a.Cin, ci = m - j * a.Cin;
    const int shift = j * a.dil - a.left;
    for (int kk = tid / (BM / 8); kk < BK; kk += THREADS / (BM / 8)) {
      const int r = r0 + kk;
      const int t = r - (r / a.T) * a.T + shift;
      const bool ok = m < m_end && r < r_end && t >= 0 && t < a.T;
      cp_async16(sA + kk * LDM + v * 8,
                 ok ? static_cast<const void*>(
                          a.x + static_cast<size_t>(r + shift) * a.Cin + ci)
                    : static_cast<const void*>(a.x),
                 ok);
    }
  } else {
    const int mm = tid % BM, m = m0 + mm;
    const int j = m / a.Cin, ci = m - j * a.Cin;
    const int shift = j * a.dil - a.left;
    for (int kk = tid / BM; kk < BK; kk += THREADS / BM) {
      const int r = r0 + kk;
      const int t = r - (r / a.T) * a.T + shift;
      const bool ok = m < m_end && r < r_end && t >= 0 && t < a.T;
      sA[kk * LDM + mm] =
          ok ? a.x[static_cast<size_t>(r + shift) * a.Cin + ci]
             : __float2bfloat16(0.0f);
    }
  }
  // B: g rows [r0, r0 + BK) x columns [n0, n0 + BN), stored [k][n]
  if ((a.Cout % 8) == 0) {
    const int v = tid % (BN / 8), n = n0 + v * 8;
    for (int kk = tid / (BN / 8); kk < BK; kk += THREADS / (BN / 8)) {
      const int r = r0 + kk;
      const bool ok = r < r_end && n < a.Cout;
      cp_async16(sB + kk * LDN + v * 8,
                 ok ? static_cast<const void*>(
                          a.g + static_cast<size_t>(r) * a.Cout + n)
                    : static_cast<const void*>(a.g),
                 ok);
    }
  } else {
    const int nn = tid % BN, n = n0 + nn;
    for (int kk = tid / BN; kk < BK; kk += THREADS / BN) {
      const int r = r0 + kk;
      sB[kk * LDN + nn] = (r < r_end && n < a.Cout)
                              ? a.g[static_cast<size_t>(r) * a.Cout + n]
                              : __float2bfloat16(0.0f);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2) dw_gemm_kernel(DwArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int r_begin = blockIdx.z * a.split_rows;
  const int r_end = min(a.rows, r_begin + a.split_rows);
  const int steps = (r_end - r_begin + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

  auto slot_a = [&](int s) { return ring + s * (DW_A + DW_B); };
  auto slot_b = [&](int s) { return ring + s * (DW_A + DW_B) + DW_A; };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps)
      dw_load_step(a, slot_a(s), slot_b(s), r_begin + s * BK, r_end, m0, n0);
    cp_async_commit();
  }

  // A [k][m] through .trans: lane l feeds k row (l / 16) * 8 + l % 8,
  // m offset ((l / 8) & 1) * 8.  B [k][n] through .trans as in K2.
  const int tk = (lane / 16) * 8 + lane % 8, tm = ((lane / 8) & 1) * 8;
  const int lr = lane % 16, lc = (lane / 16) * 8;
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = step + STAGES - 1;
    if (nxt < steps)
      dw_load_step(a, slot_a(nxt % STAGES), slot_b(nxt % STAGES),
                   r_begin + nxt * BK, r_end, m0, n0);
    cp_async_commit();

    const bf16* sA = slot_a(step % STAGES) + tk * LDM + wm * 64 + tm;
    const bf16* sB = slot_b(step % STAGES) + lr * LDN + wn * 32 + lc;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t fa[4][4], fb[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4_trans(fa[mi], sA + kk * LDM + mi * 16);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldsm_x4_trans(r, sB + kk * LDN + nj * 16);
        fb[2 * nj][0] = r[0];
        fb[2 * nj][1] = r[1];
        fb[2 * nj + 1][0] = r[2];
        fb[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], fa[mi], fb[ni]);
    }
  }
  cp_async_wait<0>();

  const int M = a.K * a.Cin;
  float* out = a.out + static_cast<size_t>(blockIdx.z) * M * a.Cout;
  const bool pair_out = (a.Cout % 2) == 0;
  const int g = lane / 4, c2 = (lane % 4) * 2;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int n = n0 + wn * 32 + ni * 8 + c2;
    if (n >= a.Cout) continue;
    const bool two = n + 1 < a.Cout;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 64 + mi * 16 + g + h * 8;
        if (m >= M) continue;
        float* dst = out + static_cast<size_t>(m) * a.Cout + n;
        const float* v = &acc[mi][ni][2 * h];
        if (pair_out && two) {
          *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
        } else {
          dst[0] = v[0];
          if (two) dst[1] = v[1];
        }
      }
    }
  }
}

// dW[i] = sum_s part[s][i], in split order (deterministic).
__global__ void dw_reduce_kernel(const float* part, float* out, int splits,
                                 size_t n) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  if ((n % 4) == 0) {
    const size_t n4 = n / 4;
    const float4* p4 = reinterpret_cast<const float4*>(part);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
         i < n4; i += stride) {
      float4 s = p4[i];
      for (int k = 1; k < splits; ++k) {
        const float4 v = p4[k * n4 + i];
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      o4[i] = s;
    }
  } else {
    for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
         i < n; i += stride) {
      float s = part[i];
      for (int k = 1; k < splits; ++k) s += part[k * n + i];
      out[i] = s;
    }
  }
}

template <typename Kern, typename Args>
int launch(Kern kern, dim3 grid, size_t smem, const Args& a,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int shift_launch(bool wt, const void* act, const void* w, void* out, int B,
                 int T, int Ca, int N, int K, int dil, int off, int sgn,
                 cudaStream_t stream) {
  ShiftArgs a;
  a.a = static_cast<const bf16*>(act);
  a.w = static_cast<const bf16*>(w);
  a.out = static_cast<bf16*>(out);
  a.rows = B * T;
  a.T = T;
  a.Ca = Ca;
  a.N = N;
  a.K = K;
  a.dil = dil;
  a.off = off;
  a.sgn = sgn;
  dim3 grid((N + BN - 1) / BN, (a.rows + BM - 1) / BM);
  return wt ? launch(shift_gemm_kernel<true>, grid, SH_SMEM, a, stream)
            : launch(shift_gemm_kernel<false>, grid, SH_SMEM, a, stream);
}

}  // namespace

extern "C" {

// K2: y (B, T, Cout) bf16 = SAME conv of x (B, T, Cin) bf16 with
// w (K, Cin, Cout) bf16.  Returns a cudaError_t.
int conv_fwd_launch(const void* x, const void* w, void* y, int B, int T,
                    int Cin, int Cout, int K, int dil, void* stream) {
  const int left = (K - 1) / 2 * dil;
  return shift_launch(false, x, w, y, B, T, Cin, Cout, K, dil, -left, 1,
                      static_cast<cudaStream_t>(stream));
}

// K4: dx (B, T, Cin) bf16 from the cotangent g (B, T, Cout) bf16 and
// w (K, Cin, Cout) bf16.  Returns a cudaError_t.
int conv_dx_launch(const void* g, const void* w, void* dx, int B, int T,
                   int Cin, int Cout, int K, int dil, void* stream) {
  const int left = (K - 1) / 2 * dil;
  return shift_launch(true, g, w, dx, B, T, Cout, Cin, K, dil, left, -1,
                      static_cast<cudaStream_t>(stream));
}

// K3: dw (K * Cin, Cout) f32 from x (B, T, Cin) bf16 and g (B, T, Cout)
// bf16.  The B*T rows are cut into `splits` ranges of `split_rows` rows
// (a multiple of 64); with splits > 1, `ws` holds splits * K*Cin*Cout f32
// partials and a second launch sums them into dw.  Returns a cudaError_t.
int conv_dw_launch(const void* x, const void* g, void* ws, void* dw,
                   int splits, int split_rows, int B, int T, int Cin,
                   int Cout, int K, int dil, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DwArgs a;
  a.x = static_cast<const bf16*>(x);
  a.g = static_cast<const bf16*>(g);
  a.out = static_cast<float*>(splits > 1 ? ws : dw);
  a.rows = B * T;
  a.T = T;
  a.Cin = Cin;
  a.Cout = Cout;
  a.K = K;
  a.dil = dil;
  a.left = (K - 1) / 2 * dil;
  a.split_rows = split_rows;
  dim3 grid((Cout + BN - 1) / BN, (K * Cin + BM - 1) / BM, splits);
  int rc = launch(dw_gemm_kernel, grid, DW_SMEM, a, s);
  if (rc != 0 || splits == 1) return rc;
  const size_t n = static_cast<size_t>(K) * Cin * Cout;
  const size_t want = (n / 4 + THREADS) / THREADS;   // >= 1
  const int blocks = static_cast<int>(want < 1024 ? want : 1024);
  dw_reduce_kernel<<<blocks, THREADS, 0, s>>>(
      static_cast<const float*>(ws), static_cast<float*>(dw), splits, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
