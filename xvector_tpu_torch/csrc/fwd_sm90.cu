// Forward of the SAME 1-D convolution for Hopper (wgmma, TMA, mbarriers,
// warp specialisation, persistent grid), in two variants that share one
// main loop:
//
//   K2 v2, the bare forward (conv_fwd_sm90_launch), replaces
//       xvector_tpu/ops/conv_bwd.py:114 _pallas_fwd (body _fwd_kernel):
//       y[b,t] = sum_j x[b, t - left + j*d] W[j]          bf16 (B, T, Cout)
//   K1 v5, one eval TDNN layer (tdnn_layer_sm90_launch), replaces one layer
//       of xvector_tpu/ops/tdnn_kernel.py:99 _fused_call (body
//       _layer_kernel): the same sum, then, on the f32 accumulators,
//       y = mask[b,t] * (act(y + bias) * scale + shift), rounded once to
//       bf16, or kept f32 for the stack's last layer.  act is relu, lrelu
//       with a scalar alpha, or prelu with a per-channel alpha.
//
// x (B, T, Cin) and W (K, Cin, Cout) are bf16, left = (K-1)/2*d, and rows
// outside [0, T) of each batch row are zeros.  Every product of a call is
// summed in f32.
//
// What bounds it on this card: operations for k > 1 (a 64 x 304 x 512,
// k=5 training call is ~1200 FLOP/byte, four times the H100's bf16 balance
// point); bytes for the k=1 TDNN layers (512 -> 512 bf16 out ~260 FLOP/byte;
// 512 -> 1536 with an f32 output ~220).  So the loop keeps the tensor cores
// fed and the epilogue writes each output once, straight from registers
// through a TMA store:
//
// * Output rows are (b, t) tiles of 8 batch rows x 16 frames = 128, by 128
//   channels of Cout; the contraction runs over (tap j, 64 channels of
//   Cin).  A is x through a (Cin, T, B) map at t0 - left + j*d, K-major:
//   the tap shift is a TMA coordinate, and the hardware zero-fills rows
//   outside [0, T), b >= B and channels >= Cin.  B is W[j] through a
//   (Cout, Cin, K) map over W as it lies (two boxes of 64 co x 64 ci x 1
//   tap), entered MN-major: no transposed copy of the weights, which change
//   every train step.
// * One producer thread issues the TMA loads into a ring of stages, each
//   guarded by a "full" mbarrier (bytes landed) and an "empty" one (the
//   consuming warpgroup done).  Two consumer warpgroups run
//   wgmma.m64n128k16 with f32 accumulators in registers, and setmaxnreg
//   moves registers from the producer (40) to them (232).
// * Ping-pong: each consumer warpgroup owns whole tiles (every other tile
//   of its block, 128 rows as two m64n128 halves, 128 accumulators a
//   thread).  The two take turns at the main loop in ring order (a "turn"
//   mbarrier each), so one group's epilogue runs while the other's main
//   loop keeps the tensor cores busy: at 8 steps a tile (the k=1 layers)
//   the epilogue is a third of a tile's time and would otherwise stall
//   them.
// * The grid is persistent: one block per SM walks the tile list
//   tile = blockIdx.x + i * gridDim.x with Cout tiles fastest, so the
//   blocks that share A rows run together and find them in L2 (the
//   1536-channel layer has 12 column tiles per row tile).
// * The epilogue is a template parameter.  BARE rounds to bf16 into
//   swizzled shared memory and TMA-stores through a (Cout, T, B) map that
//   clips t >= T and b >= B.  TDNN_BF16 / TDNN_F32 first apply the TDNN
//   epilogue in K1's order (bias, activation, scale/shift, row mask) with
//   the tile's 128-column vectors staged in shared memory once per tile
//   and the row mask read per thread for its four rows; TDNN_F32 stores
//   f32 in two passes of 64 columns (two 32-column boxes each).
// * Shared memory: 32 KB stages (A 16 KB, B 16 KB) and a 32 KB staging
//   tile per consumer.  BARE keeps 5 stages (225.1 KB); the TDNN variants'
//   column vectors (2 KB a consumer) leave room for 4.
//
// Shapes: every channel count a multiple of 8 (TMA's 16-byte global
// strides); ops/conv_bwd.py:route and ops/tdnn_kernel.py:layer_route send
// the rest to conv_bwd.cu and tdnn_stack.cu.  Each launch function encodes
// its tensor maps on the host and passes them as __grid_constant__
// parameters.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int THREADS = 384;         // WG0, WG1: consumers; WG2: producer
constexpr int PRODUCER = 256;        // the thread that issues TMA
constexpr int ALIGN = 1024;          // 128-byte swizzle atoms

constexpr int TT = 16, BB = 8;       // output rows per tile: 8 x 16 = 128
constexpr int BN = 128;              // Cout columns per tile
constexpr int A_BYTES = 128 * 128;   // 128 rows x 64 ci, bf16
constexpr int W_BOX = 64 * 128;      // 64 ci x 64 co, bf16
constexpr int STAGE = A_BYTES + 2 * W_BOX;
constexpr int OUT_BOX = 128 * 128;   // 128 rows x 64 bf16 or 32 f32
constexpr int OUT = 2 * OUT_BOX;     // a consumer's staging: two boxes
constexpr int VEC = 4 * BN * 4;      // bias, scale, shift, alpha (f32)

enum Epi { BARE = 0, TDNN_BF16 = 1, TDNN_F32 = 2 };
enum Act { RELU = 0, LRELU = 1, PRELU = 2 };

template <int E>
struct Cfg {
  // a consumer's 128 x 128 tile goes out through its staging in PASSES
  // passes: one in bf16, two of 64 columns in f32
  static constexpr int PASSES = E == TDNN_F32 ? 2 : 1;
  static constexpr int BOX_COLS = E == TDNN_F32 ? 32 : 64;
  static constexpr int STAGES = E == BARE ? 5 : 4;
  static constexpr int VECS = E == BARE ? 0 : VEC;
  // per consumer: staging and vectors; then full, empty and turn barriers
  static constexpr int SMEM = ALIGN + STAGES * STAGE + 2 * (OUT + VECS) +
                              (2 * STAGES + 2) * 8;
  static_assert(SMEM <= 232448, "fits a block's shared memory");
};

struct FwdParams {
  int B, T, cout, k, dil, left;
  int nt;        // ceil(T / TT)
  int n_tiles;   // ceil(Cout / BN)
  int tiles;     // ceil(B / BB) * nt * n_tiles
  int nci;       // ceil(Cin / 64)
  // TDNN epilogue (unused by BARE)
  const float* mask;    // (B, T)
  const float* bias;    // (Cout)
  const float* scale;   // (Cout)
  const float* shift;   // (Cout)
  const float* alpha;   // (Cout), prelu only
  int act;
  float lrelu_alpha;
};

__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((ALIGN - (a & (ALIGN - 1))) & (ALIGN - 1));
}

// The TDNN epilogue on one accumulator value of column c (of the tile) in
// K1's order: bias, activation, scale/shift, the row's mask.
__device__ __forceinline__ float tdnn_epilogue(float y, const float* vec,
                                               int c, float mask, int act,
                                               float lrelu_alpha) {
  const float a = y + vec[c];
  const float slope = act == PRELU ? vec[3 * BN + c] : lrelu_alpha;
  const float r = act == RELU ? fmaxf(a, 0.0f)
                              : fmaxf(a, 0.0f) + slope * fminf(a, 0.0f);
  return (r * vec[BN + c] + vec[2 * BN + c]) * mask;
}

// One 64-row half (rows 64 * half ..) of a consumer's tile, the columns of
// pass `pass` (all 128 in bf16, 64 a pass in f32), from its accumulators
// into the swizzled staging boxes, after the epilogue E.
template <int E>
__device__ __forceinline__ void stage_half(const float (&acc)[64], int half,
                                           int pass, unsigned char* out,
                                           const float* vec,
                                           const float (&m)[2][2],
                                           const FwdParams& p, int warp,
                                           int lane) {
  using C = Cfg<E>;
  constexpr int I_PER_PASS = 16 / C::PASSES;   // 8-column groups a pass
#pragma unroll
  for (int ii = 0; ii < I_PER_PASS; ++ii) {
    const int i = pass * I_PER_PASS + ii;
    const int col = 8 * i + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 64 * half + 16 * warp + lane / 4 + 8 * h;
      float y0 = acc[4 * i + 2 * h], y1 = acc[4 * i + 2 * h + 1];
      if constexpr (E != BARE) {
        y0 = tdnn_epilogue(y0, vec, col, m[half][h], p.act, p.lrelu_alpha);
        y1 = tdnn_epilogue(y1, vec, col + 1, m[half][h], p.act,
                           p.lrelu_alpha);
      }
      if constexpr (E == TDNN_F32) {
        // two [128 rows][32 f32] boxes; 16-byte chunks swizzled by row
        const int lc = col - 64 * pass, cc = lc % 32;
        const uint32_t off = (lc / 32) * OUT_BOX + row * 128 +
                             (((cc / 4) ^ (row & 7)) * 16) + (cc % 4) * 4;
        *reinterpret_cast<float2*>(out + off) = make_float2(y0, y1);
      } else {
        // two [128 rows][64 bf16] boxes
        const uint32_t off = (i / 8) * OUT_BOX + row * 128 +
                             (((i % 8) ^ (row & 7)) * 16) + (lane % 4) * 4;
        *reinterpret_cast<__nv_bfloat162*>(out + off) =
            __floats2bfloat162_rn(y0, y1);
      }
    }
  }
}

template <int E>
__global__ void __launch_bounds__(THREADS, 1)
    fwd_sm90_kernel(const __grid_constant__ CUtensorMap mx,
                    const __grid_constant__ CUtensorMap mw,
                    const __grid_constant__ CUtensorMap mo, FwdParams p) {
  using C = Cfg<E>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + C::STAGES * STAGE + 2 * (OUT + C::VECS);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (C::STAGES + s); };
  // turn(w): the other consumer has finished a main loop, so w may start
  // its next one
  auto turn = [&](int w) { return bars + 8 * (2 * C::STAGES + w); };
  const int steps = p.k * p.nci;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);   // the four warps of the consuming group
    }
    mbar_init(turn(0), 1);
    mbar_init(turn(1), 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: runs through every tile's stages without a break ----
    setmaxnreg_dec<40>();
    if (threadIdx.x == PRODUCER) {
      int it = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int mt = tile / p.n_tiles, n0 = (tile % p.n_tiles) * BN;
        const int b0 = (mt / p.nt) * BB, t0 = (mt % p.nt) * TT;
        for (int step = 0; step < steps; ++step, ++it) {
          const int j = step / p.nci, ci0 = (step % p.nci) * 64;
          const int s = it % C::STAGES;
          mbar_wait(empty(s), ((it / C::STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(full(s), STAGE);
          const uint32_t st = base + s * STAGE;
          tma_load_3d(&mx, full(s), st, ci0, t0 - p.left + j * p.dil, b0);
          tma_load_3d(&mw, full(s), st + A_BYTES, n0, ci0, j);
          tma_load_3d(&mw, full(s), st + A_BYTES + W_BOX, n0 + 64, ci0, j);
        }
      }
    }
    return;
  }

  // ---- consumers, ping-pong: WG w owns the block's tiles w, w + 2, ... and
  // computes all 128 rows of each (two m64n128 halves); the two groups take
  // turns at the main loop in ring order, and one's epilogue runs while the
  // other's main loop keeps the tensor cores busy ----
  setmaxnreg_inc<232>();
  const int wtid = threadIdx.x % 128, lane = wtid % 32, warp = wtid / 32;
  const uint32_t bar_id = 1 + wg;          // this group's named barrier
  unsigned char* out_smem = smem + C::STAGES * STAGE + wg * (OUT + C::VECS);
  const uint32_t out_base = smem_u32(out_smem);
  float* vec = reinterpret_cast<float*>(out_smem + OUT);
  int it = wg * steps;   // the ring position of this group's first tile
  int turns = 0;
  for (int tile = blockIdx.x + wg * gridDim.x; tile < p.tiles;
       tile += 2 * gridDim.x, it += steps, ++turns) {
    const int mt = tile / p.n_tiles, n0 = (tile % p.n_tiles) * BN;
    const int b0 = (mt / p.nt) * BB, t0 = (mt % p.nt) * TT;

    // TDNN: the tile's column vectors and this thread's four row-mask
    // values, loaded before the main loop so their latency hides under it
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float m[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
    if constexpr (E != BARE) {
      const int c = n0 + wtid;
      if (c < p.cout) {
        v[0] = p.bias[c];
        v[1] = p.scale[c];
        v[2] = p.shift[c];
        if (p.act == PRELU) v[3] = p.alpha[c];
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int b = b0 + warp + 4 * half;   // a half-row's batch row
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = t0 + lane / 4 + 8 * h;
          if (b < p.B && t < p.T)
            m[half][h] = p.mask[static_cast<size_t>(b) * p.T + t];
        }
      }
    }

    // Wait until every stage of the other group's last tile has landed: a
    // stage's full barrier is then at most one phase behind the phase we
    // wait for, as a parity wait needs (WG0's first tile goes at once).
    mbar_wait(turn(wg), (turns & 1) ^ (wg == 0));
    float acc0[64], acc1[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      acc0[i] = 0.0f;
      acc1[i] = 0.0f;
    }
    for (int step = 0; step < steps; ++step, ++it) {
      const int s = it % C::STAGES;
      mbar_wait(full(s), (it / C::STAGES) & 1);
      const uint32_t st = base + s * STAGE;
      fence_regs(acc0);
      fence_regs(acc1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {   // 16 channels of Cin each
        // A K-major: +32 bytes per 16 channels, rows 64.. 8 KB on; B
        // MN-major: +16 rows of 128 bytes, the two 64-column boxes W_BOX
        // apart
        const uint64_t db = desc_sw128(st + A_BYTES + kk * 2048, W_BOX,
                                       1024);
        wgmma_m64n128<0, 1>(acc0, desc_sw128(st + kk * 32, 16, 1024), db);
        wgmma_m64n128<0, 1>(acc1, desc_sw128(st + 64 * 128 + kk * 32, 16,
                                             1024), db);
      }
      wgmma_commit();
      fence_regs(acc0);
      fence_regs(acc1);
      wgmma_wait<1>();
      fence_regs(acc0);
      fence_regs(acc1);
      if (step > 0 && lane == 0) mbar_arrive(empty((it - 1) % C::STAGES));
    }
    // every stage of this tile has landed: the other group's turn
    if (wtid == 0) mbar_arrive(turn(wg ^ 1));
    wgmma_wait<0>();
    fence_regs(acc0);
    fence_regs(acc1);
    if (lane == 0) mbar_arrive(empty((it - 1) % C::STAGES));

    // ---- epilogue: into swizzled shared memory, then TMA ----
    if (wtid == 0) bulk_wait_read<0>();   // our last store has read
    if constexpr (E != BARE) {
#pragma unroll
      for (int q = 0; q < 4; ++q) vec[q * BN + wtid] = v[q];
    }
    named_bar_sync(bar_id, 128);
#pragma unroll
    for (int pass = 0; pass < C::PASSES; ++pass) {
      if (pass > 0) {                      // the first half has been read
        if (wtid == 0) bulk_wait_read<0>();
        named_bar_sync(bar_id, 128);
      }
      stage_half<E>(acc0, 0, pass, out_smem, vec, m, p, warp, lane);
      stage_half<E>(acc1, 1, pass, out_smem, vec, m, p, warp, lane);
      fence_proxy_async();
      named_bar_sync(bar_id, 128);
      if (wtid == 0) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int c0 = n0 + pass * 64 + q * C::BOX_COLS;
          if (c0 < p.cout)
            tma_store_3d(&mo, out_base + q * OUT_BOX, c0, t0, b0);
        }
        bulk_commit();
      }
    }
  }
  if (wtid == 0) bulk_wait<0>();
}

template <int E>
int fwd_launch(const void* x, const void* w, void* y, int blocks, int cin,
               FwdParams p, cudaStream_t stream) {
  using C = Cfg<E>;
  static const int attr = static_cast<int>(cudaFuncSetAttribute(
      fwd_sm90_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM));
  if (attr != 0) return attr;
  CUtensorMap mx, mw, mo;
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  int rc = make_map_3d(&mx, bf, 2, x, cin, p.T, p.B, 64, TT, BB,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0)
    rc = make_map_3d(&mw, bf, 2, w, p.cout, cin, p.k, 64, 64, 1,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0) {
    if (E == TDNN_F32)
      rc = make_map_3d(&mo, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, y, p.cout,
                       p.T, p.B, 32, TT, BB, CU_TENSOR_MAP_SWIZZLE_128B);
    else
      rc = make_map_3d(&mo, bf, 2, y, p.cout, p.T, p.B, 64, TT, BB,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (rc != 0) return rc;
  p.left = (p.k - 1) / 2 * p.dil;
  p.nt = (p.T + TT - 1) / TT;
  p.n_tiles = (p.cout + BN - 1) / BN;
  p.tiles = (p.B + BB - 1) / BB * p.nt * p.n_tiles;
  p.nci = (cin + 63) / 64;
  const int grid = blocks < p.tiles ? blocks : p.tiles;
  fwd_sm90_kernel<E><<<grid, THREADS, C::SMEM, stream>>>(mx, mw, mo, p);
  return static_cast<int>(cudaGetLastError());
}

FwdParams shape(int B, int T, int cout, int k, int dil) {
  FwdParams p = {};
  p.B = B;
  p.T = T;
  p.cout = cout;
  p.k = k;
  p.dil = dil;
  return p;
}

}  // namespace

extern "C" {

// K2 v2: y (B, T, Cout) bf16 from x (B, T, Cin) and w (K, Cin, Cout) bf16,
// on a persistent grid of `blocks` blocks (at most one per SM).  Channel
// counts must be multiples of 8.  Returns 0, a cudaError_t, or an
// sm90::ERR_* code.
int conv_fwd_sm90_launch(const void* x, const void* w, void* y, int blocks,
                         int B, int T, int cin, int cout, int k, int dil,
                         void* stream) {
  return fwd_launch<BARE>(x, w, y, blocks, cin, shape(B, T, cout, k, dil),
                          static_cast<cudaStream_t>(stream));
}

// K1 v5, one eval TDNN layer: out (B, T, Cout), bf16 or, with out_f32 != 0,
// f32, from x (B, T, Cin) bf16, w (K, Cin, Cout) bf16, the f32 (Cout)
// vectors bias, scale, shift and (prelu only; may be null otherwise)
// alpha, and the f32 (B, T) row mask.  act: 0 relu, 1 lrelu (slope
// lrelu_alpha), 2 prelu.  Channel counts must be multiples of 8.  Returns
// 0, a cudaError_t, or an sm90::ERR_* code.
int tdnn_layer_sm90_launch(const void* x, const void* mask, const void* w,
                           const void* bias, const void* scale,
                           const void* shift, const void* alpha, void* out,
                           int out_f32, int blocks, int B, int T, int cin,
                           int cout, int k, int dil, int act,
                           float lrelu_alpha, void* stream) {
  if (act < RELU || act > PRELU || (act == PRELU && alpha == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  FwdParams p = shape(B, T, cout, k, dil);
  p.mask = static_cast<const float*>(mask);
  p.bias = static_cast<const float*>(bias);
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.alpha = static_cast<const float*>(alpha);
  p.act = act;
  p.lrelu_alpha = lrelu_alpha;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_f32) return fwd_launch<TDNN_F32>(x, w, out, blocks, cin, p, s);
  return fwd_launch<TDNN_BF16>(x, w, out, blocks, cin, p, s);
}

}  // extern "C"
