// Eval-mode TDNN frame stack, one layer per launch, for Hopper (sm_90a):
// K1 v4, the "sm80" design of ops/tdnn_kernel.py:layer_route.  No layer of
// a model-zoo stack takes it by the rule: layer 0 runs the Hopper layer-0
// kernel (fwd_sm90.cu, tdnn_l0_sm90_kernel) and every later layer K1 v5
// (fwd_sm90.cu: wgmma, TMA, the forward K2 v2 shares).  It serves layer 0
// only where that kernel cannot hold the layer in shared memory
// (ops/tdnn_kernel.py:l0_takes: k * F beyond ~320), and every layer under
// design="sm80", which the chip smoke times against the Hopper designs.
//
// Replaces the TPU kernel xvector_tpu/ops/tdnn_kernel.py:_layer_kernel /
// _fused_call (K1), which runs the whole 5-layer stack in one Pallas call
// with f32 intermediates resident in VMEM.  Per layer it computes
//
//   y[b,t,:] = mask[b,t] * (act(sum_j bf16(h[b, t - left + j*d, :]) @ W[j]
//                               + bias) * scale + shift)
//
// with bf16 operands, f32 accumulation, zero padding outside [0, T), and
// the eval batch norm folded into (scale, shift).  Layer 0 reads the f32
// features and multiplies by the mask before rounding, as K1 does.
//
// What bounds it on this card: operations.  At the flagship extraction
// shape (32 x 1024 frames, no_dropout) one stack call is ~2.79e11 FLOP
// against ~0.21 GB of compulsory traffic (f32 features in, f32 1536-ch
// output), i.e. ~1300 FLOP/byte, far above the H100's ~295 FLOP/byte
// balance point in bf16.
//
// What the design does about it: every product runs on the tensor cores
// (mma.sync m16n8k16, bf16 operands fed by ldmatrix, f32 accumulators in
// registers), and the operand loads are kept off the critical path.  Each
// layer is an implicit GEMM whose contraction runs over (tap j, input
// channel) jointly, in W's (K * Cin, Cout) row order: an A column (j, c) is
// input channel c at rows shifted by j*d, read straight from device memory
// with the shift in the address (zero-filled outside [0, T)), so no
// unfolded copy of the input is ever written, and the 5 x 23 first layer
// packs into two 64-deep steps.  A block owns a 128-frame x 128-channel output tile (8 warps of
// 64 x 32) and streams 64-deep A and W slices through a 3-stage cp.async
// ring in shared memory (105 KB, two blocks per SM), so the loads of step
// s+2 overlap the products of step s.  Shapes that are not multiples of 8
// channels (the 23-dim features, etdnn's 1500 channels) and the f32
// layer-0 input take predicated scalar loads into the same ring.  The
// epilogue (bias, activation, scale/shift, mask) runs on the accumulator
// registers and stores channel pairs, so each layer writes its output once.
//
// K1's f32 (t_tile + 2 halo) x 512 intermediates (~550 KB at t_tile = 256)
// do not fit in 227 KB of shared memory, so layers run as separate launches
// and hand over bf16 activations through device memory; that is exact with
// respect to K1, which consumes every intermediate only through a bf16
// cast.  The last layer writes f32.  A one-launch stack with on-chip
// intermediates is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "mma_sm80.cuh"

namespace {

constexpr int BM = 128;        // frames per block
constexpr int BN = 128;        // output channels per block
constexpr int BK = 64;         // contraction depth per pipeline step
constexpr int STAGES = 3;      // cp.async ring depth
constexpr int LDA = BK + 8;    // 72 bf16 (144 B rows): conflict-free ldmatrix
constexpr int LDB = BN + 8;    // 136 bf16 (272 B rows)
constexpr int THREADS = 256;   // 8 warps: 2 along frames x 4 along channels
constexpr int A_STAGE = BM * LDA;
constexpr int B_STAGE = BK * LDB;
static_assert(THREADS % BK == 0 && THREADS % (BN / 8) == 0 &&
                  THREADS % (BK / 8) == 0 && THREADS % BN == 0,
              "each thread keeps one column of every staged tile");
constexpr size_t SMEM_BYTES =
    static_cast<size_t>(STAGES) * (A_STAGE + B_STAGE) * sizeof(bf16);

enum Act { RELU = 0, LRELU = 1, PRELU = 2 };

struct LayerArgs {
  const void* x;        // (B, T, Cin), f32 (layer 0) or bf16
  const float* mask;    // (B, T)
  const bf16* w;        // (K, Cin, Cout)
  const float* bias;    // (Cout)
  const float* scale;   // (Cout)
  const float* shift;   // (Cout)
  const float* alpha;   // (Cout), prelu only
  void* out;            // (B, T, out_cols), bf16 or f32 (last layer)
  int B, T, Cin, Cout, K, dil, act;
  int out_cols;         // <= Cout: the columns written (W's may be padded)
  float lrelu_alpha;
};

__device__ __forceinline__ float load_in(const float* x, size_t i) {
  return x[i];
}
__device__ __forceinline__ float load_in(const bf16* x, size_t i) {
  return __bfloat162float(x[i]);
}

__device__ __forceinline__ void store2(float* y, const float* v) {
  *reinterpret_cast<float2*>(y) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void store2(bf16* y, const float* v) {
  *reinterpret_cast<__nv_bfloat162*>(y) = __floats2bfloat162_rn(v[0], v[1]);
}
__device__ __forceinline__ void store1(float* y, float v) { *y = v; }
__device__ __forceinline__ void store1(bf16* y, float v) {
  *y = __float2bfloat16(v);
}

// Stage contraction step `step` of this block's tile into the ring slot at
// (sA, sB).  The contraction index kc runs over (tap j, input channel c)
// as kc = j * Cin + c, the row order of W viewed as (K * Cin, Cout), so a
// narrow layer (23 features x 5 taps = 115) packs into two 64-deep steps
// instead of five mostly-zero ones.  A[r][kc] = x[t0 + r + j*d - left][c].
// Thread-to-column assignments repeat every THREADS elements, so each
// thread decodes its (j, c) once per step.
template <typename Tin>
__device__ __forceinline__ void load_step(const LayerArgs& a, bf16* sA,
                                          bf16* sB, int step, int n0, int t0,
                                          size_t row0, int left) {
  const int kc0 = step * BK;
  const int kc_end = a.K * a.Cin;
  const Tin* x = static_cast<const Tin*>(a.x);
  const int tid = threadIdx.x;

  if (sizeof(Tin) == 2 && (a.Cin % 8) == 0) {
    // 16-byte vectors: 8 channels of one tap (Cin % 8 == 0 keeps them whole)
    constexpr int VPR = BK / 8;   // vectors per row
    const int v = tid % VPR, kc = kc0 + v * 8;
    const int j = kc / a.Cin, c = kc - j * a.Cin;
    const int shift = j * a.dil - left;
    for (int r = tid / VPR; r < BM; r += THREADS / VPR) {
      const int t = t0 + r + shift;
      const bool ok = kc < kc_end && t >= 0 && t < a.T;
      cp_async16(sA + r * LDA + v * 8,
                 ok ? static_cast<const void*>(x + (row0 + t) * a.Cin + c)
                    : a.x,
                 ok);
    }
  } else {
    const int cc = tid % BK, kc = kc0 + cc;
    const int j = kc / a.Cin, c = kc - j * a.Cin;
    const int shift = j * a.dil - left;
    for (int r = tid / BK; r < BM; r += THREADS / BK) {
      const int t = t0 + r + shift;
      float v = 0.0f;
      if (kc < kc_end && t >= 0 && t < a.T) {
        v = load_in(x, (row0 + t) * a.Cin + c);
        // layer 0 takes raw f32 features: mask them before the bf16 cast
        if (sizeof(Tin) == 4) v *= a.mask[row0 + t];
      }
      sA[r * LDA + cc] = __float2bfloat16(v);
    }
  }
  // B: rows [kc0, kc0 + BK) of W as (K * Cin, Cout), columns [n0, n0 + BN)
  if ((a.Cout % 8) == 0) {
    constexpr int VPR = BN / 8;
    const int v = tid % VPR, co = n0 + v * 8;
    for (int cc = tid / VPR; cc < BK; cc += THREADS / VPR) {
      const int kc = kc0 + cc;
      const bool ok = kc < kc_end && co < a.Cout;
      cp_async16(sB + cc * LDB + v * 8,
                 ok ? static_cast<const void*>(
                          a.w + static_cast<size_t>(kc) * a.Cout + co)
                    : static_cast<const void*>(a.w),
                 ok);
    }
  } else {
    const int n = tid % BN, co = n0 + n;
    for (int cc = tid / BN; cc < BK; cc += THREADS / BN) {
      const int kc = kc0 + cc;
      sB[cc * LDB + n] = (kc < kc_end && co < a.Cout)
                             ? a.w[static_cast<size_t>(kc) * a.Cout + co]
                             : __float2bfloat16(0.0f);
    }
  }
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(THREADS, 2)
tdnn_layer_kernel(LayerArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);

  const int n0 = blockIdx.x * BN;
  const int t0 = blockIdx.y * BM;
  const size_t row0 = static_cast<size_t>(blockIdx.z) * a.T;
  const int left = (a.K - 1) / 2 * a.dil;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4;   // 0..1: 64-frame slice
  const int wn = warp % 4;   // 0..3: 32-channel slice
  const int steps = (a.K * a.Cin + BK - 1) / BK;

  // acc[mi][ni]: the m16n8 tile at rows wm*64 + mi*16, cols wn*32 + ni*8
  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

  auto slot_a = [&](int s) { return ring + s * (A_STAGE + B_STAGE); };
  auto slot_b = [&](int s) { return ring + s * (A_STAGE + B_STAGE) + A_STAGE; };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps)
      load_step<Tin>(a, slot_a(s), slot_b(s), s, n0, t0, row0, left);
    cp_async_commit();
  }

  // ldmatrix row addresses: lane l feeds row (l % 16), column (l / 16) * 8
  // of a 16x16 tile, for A as stored and for B through .trans
  const int lr = lane % 16, lc = (lane / 16) * 8;
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // step's slot is filled; slot step-1 is free
    const int nxt = step + STAGES - 1;
    if (nxt < steps)
      load_step<Tin>(a, slot_a(nxt % STAGES), slot_b(nxt % STAGES), nxt, n0,
                     t0, row0, left);
    cp_async_commit();

    const bf16* sA = slot_a(step % STAGES) + (wm * 64 + lr) * LDA + lc;
    const bf16* sB = slot_b(step % STAGES) + lr * LDB + wn * 32 + lc;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t fa[4][4], fb[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(fa[mi], sA + mi * 16 * LDA + kk);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {   // 16 channels = two n8 tiles
        uint32_t r[4];
        ldsm_x4_trans(r, sB + kk * LDB + nj * 16);
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

  // ---- epilogue from registers: bias, activation, BN affine, mask.
  // Thread holds rows g and g+8 of each tile, 2 adjacent channels each.
  Tout* out = static_cast<Tout*>(a.out);
  const bool pair_out = (a.out_cols % 2) == 0;
  const int g = lane / 4, c2 = (lane % 4) * 2;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int co = n0 + wn * 32 + ni * 8 + c2;
    if (co >= a.out_cols) continue;
    const bool two = co + 1 < a.out_cols;
    float bias[2], scale[2], shift[2], alpha[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = two ? co + e : co;
      bias[e] = a.bias[c];
      scale[e] = a.scale[c];
      shift[e] = a.shift[c];
      alpha[e] = a.act == PRELU ? a.alpha[c] : a.lrelu_alpha;
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + wm * 64 + mi * 16 + g + h * 8;
        if (t >= a.T) continue;
        const float m = a.mask[row0 + t];
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = acc[mi][ni][2 * h + e] + bias[e];
          v = a.act == RELU ? fmaxf(v, 0.0f)
                            : fmaxf(v, 0.0f) + alpha[e] * fminf(v, 0.0f);
          y[e] = (v * scale[e] + shift[e]) * m;
        }
        Tout* dst = out + (row0 + t) * a.out_cols + co;
        if (pair_out && two) {
          store2(dst, y);
        } else {
          store1(dst, y[0]);
          if (two) store1(dst + 1, y[1]);
        }
      }
    }
  }
}

template <typename Tin, typename Tout>
int launch(const LayerArgs& a, cudaStream_t stream) {
  auto kern = tdnn_layer_kernel<Tin, Tout>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.Cout + BN - 1) / BN, (a.T + BM - 1) / BM, a.B);
  kern<<<grid, THREADS, SMEM_BYTES, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One TDNN layer.  x_f32 != 0: x is f32 (layer 0, masked here) else bf16.
// out_f32 != 0: out is f32 (last layer) else bf16; out is (B, T, out_cols)
// and takes the first out_cols <= Cout columns.  Returns a cudaError_t.
int tdnn_layer_launch(const void* x, int x_f32, const void* mask,
                      const void* w, const void* bias, const void* scale,
                      const void* shift, const void* alpha, void* out,
                      int out_f32, int B, int T, int Cin, int Cout,
                      int out_cols, int K, int dil, int act,
                      float lrelu_alpha, void* stream) {
  if (out_cols < 1 || out_cols > Cout)
    return static_cast<int>(cudaErrorInvalidValue);
  LayerArgs a;
  a.x = x;
  a.mask = static_cast<const float*>(mask);
  a.w = static_cast<const bf16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.scale = static_cast<const float*>(scale);
  a.shift = static_cast<const float*>(shift);
  a.alpha = static_cast<const float*>(alpha);
  a.out = out;
  a.B = B;
  a.T = T;
  a.Cin = Cin;
  a.Cout = Cout;
  a.out_cols = out_cols;
  a.K = K;
  a.dil = dil;
  a.act = act;
  a.lrelu_alpha = lrelu_alpha;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_f32 && out_f32) return launch<float, float>(a, s);
  if (x_f32) return launch<float, bf16>(a, s);
  if (out_f32) return launch<bf16, float>(a, s);
  return launch<bf16, bf16>(a, s);
}

}  // extern "C"
