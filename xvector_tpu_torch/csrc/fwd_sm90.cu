// Forward of the SAME 1-D convolution for Hopper (wgmma, TMA, mbarriers,
// warp specialisation, persistent grid), in two variants that share one
// main loop, and a third for K1's layer 0 that shares their consumers:
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
//   K1 layer 0 (tdnn_l0_sm90_launch), the same layer on the f32 features
//       (B, T, F), any F: y[b,t] = mask[b,t] * (act(sum_j bf16(mask[b,s] *
//       x[b,s]) W0[j] + bias) * scale + shift), s = t - left + j*d.
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
// strides); ops/conv_bwd.py:route sends the rest of K2's calls to
// conv_bwd.cu, and K1's fold (ops/tdnn_kernel.py:fold_stack) zero-pads
// its channel counts to multiples of 8, so every K1 layer after the first
// runs here.  Each launch function encodes its tensor maps on the host and
// passes them as __grid_constant__ parameters.
//
// The layer-0 kernel.  A 23-channel f32 row is 92 bytes, which no TMA map
// takes (16-byte strides), and an f32 input is the wrong type for a bf16
// operand map at any F; the layer is bound by its bf16 output (32 x 1024 x
// 512: 33.5 of the 36.8 MB it moves; 3.9 us of operations against 11.0 us
// of bytes on the H100).  So only A's source changes:
// * A row tile is 128 frames of one utterance (one halo, where v5's 8 x 16
//   tile would carry eight), by all of Cout.  Producer warps 9-11 copy its
//   window (the 128 + (k-1)*d frames of features and mask it reads, a
//   contiguous run of the flat input) into shared memory with 4-byte
//   cp.async copies, all in flight at once and issued as soon as the last
//   A tile is built (they overlap the wait for a free A tile), then build
//   A's im2col rows from it: K =
//   (tap, channel) = k * F zero-padded to a multiple of 64 (5 x 23 = 115
//   -> 128; 5 x 40 = 200 -> 256), masked, rounded to bf16 and stored
//   straight into the 128-byte-swizzled K-major layout wgmma reads (a lane
//   owns a column; eight rows' loads go before their stores).  Two A tiles
//   when they fit (the next row tile is built while the consumers run on
//   this one), else one; "a_full"/"a_empty" mbarriers hand them over.  The
//   block's first A tile, which no other work hides, is built by the eight
//   consumer warps too (11 warps, behind named barrier 4).
// * W0 is packed at fold time as (kpad, Cout) bf16 in (tap, channel) row
//   order, and warp 8 streams its column tiles by TMA through a ring of
//   16 KB stages (the 128 KB W0 of the recipe does not fit beside two A
//   tiles and the staging; it stays in L2).
// * Each A tile serves every Cout tile of its row tile; the consumers and
//   the TMA store through swizzled staging are v5's (the output box is 128
//   frames of one utterance).  The epilogue reads bias, scale, shift and
//   alpha once per column pair (float2) from a copy every block keeps for
//   all of Cout: v5's epilogue, which reads them from shared memory for
//   every value, was the largest part of this kernel's first versions.

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
  int out_cols;  // <= cout: the output's columns (W's may be zero-padded)
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
                                           const float (&m)[2][2], int act,
                                           float lrelu_alpha, int warp,
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
        y0 = tdnn_epilogue(y0, vec, col, m[half][h], act, lrelu_alpha);
        y1 = tdnn_epilogue(y1, vec, col + 1, m[half][h], act, lrelu_alpha);
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
      stage_half<E>(acc0, 0, pass, out_smem, vec, m, p.act, p.lrelu_alpha,
                    warp, lane);
      stage_half<E>(acc1, 1, pass, out_smem, vec, m, p.act, p.lrelu_alpha,
                    warp, lane);
      fence_proxy_async();
      named_bar_sync(bar_id, 128);
      if (wtid == 0) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int c0 = n0 + pass * 64 + q * C::BOX_COLS;
          if (c0 < p.out_cols)
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
      rc = make_map_3d(&mo, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, y,
                       p.out_cols, p.T, p.B, 32, TT, BB,
                       CU_TENSOR_MAP_SWIZZLE_128B);
    else
      rc = make_map_3d(&mo, bf, 2, y, p.out_cols, p.T, p.B, 64, TT, BB,
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
  p.out_cols = cout;
  p.k = k;
  p.dil = dil;
  return p;
}

// ---------------------------------------------------------------------------
// K1 layer 0 (tdnn_l0_sm90_kernel): the f32 features in, A built in shared
// memory by producer warps
// ---------------------------------------------------------------------------

constexpr int L0_ROWS = 128;           // frames of one utterance per row tile
constexpr int A_CHUNK = 128 * 128;     // 128 rows x 64 columns of K, bf16
constexpr int W_STAGE = 2 * W_BOX;     // 64 rows of K x 128 Cout columns
constexpr int BUILDERS = 96;           // warps 9-11 build A
constexpr int WIN_BLOCK = 256;         // window floats come in blocks of 256
constexpr int L0_SMEM = 232448;        // a block's shared memory on sm_90

struct L0Params {
  const float* x;       // (B, T, F) f32 features
  const float* mask;    // (B, T)
  const float* bias;    // (cout) f32, as the packed W0's columns
  const float* scale;
  const float* shift;
  const float* alpha;   // prelu only
  int B, T, F, K;       // K = k * F: the packed W0's real rows
  int kpad;             // W0's rows: K rounded up to 64
  int k, dil, left;
  uint32_t fdiv;        // ceil(2^20 / F): c / F == (c * fdiv) >> 20 here
  int cout, out_cols;
  int nt;               // ceil(T / L0_ROWS)
  int row_tiles;        // B * nt
  int n_tiles;          // ceil(cout / BN)
  int chunks;           // kpad / 64: W stages per tile
  int win_rows;         // L0_ROWS + (k - 1) * dil frames a row tile reads
  int x_blocks, m_blocks;  // window blocks: features, mask
  int vec_cols;         // cout rounded up to BN: each resident vector's row
  int n_abuf, stages;   // A tiles and W stages the shared memory holds
  int act;
  float lrelu_alpha;
};

// window[e] = src[start + e] for e < n, zero where start + e leaves
// [0, total): the builders' coalesced copy of a row tile's frames, issued
// as 4-byte cp.async copies (zero-filled outside), all in flight at once;
// cp.async.wait_all completes it.
__device__ __forceinline__ void fill_window(float* window, const float* src,
                                            int start, int n, int total,
                                            int tid) {
  for (int e = tid; e < n; e += BUILDERS) {
    const int g = start + e;
    const bool ok = g >= 0 && g < total;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_u32(window + e)),
                 "l"(src + (ok ? g : 0)), "r"(ok ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A for row tile (b, t0) from its window: xw holds the features of frames
// s0 = t0 - left .. s0 + win_rows - 1 of the flat (B * T, F) array (rows of
// other utterances, or zeros, where they leave [0, T)), mw their mask.
// Row r, column c = j * F + ch of K is bf16(mask[b, s] * x[b, s, ch]) at
// s = s0 + r + j * dil, zero outside [0, T) and for c >= K.  It is stored
// as kpad / 64 chunks of 128 rows x 128 bytes, each 16-byte unit u of row r
// at u ^ (r & 7): the layout a TMA load with 128-byte swizzle gives, which
// wgmma reads K-major.  The nw building warps take items of 32 columns x
// 16 rows in turn (this is warp bw); a lane keeps one column (for dil = 1
// the warp reads 32 neighbouring window floats a row: no bank conflicts).
__device__ __forceinline__ void build_a(unsigned char* a, const float* xw,
                                        const float* mw, const L0Params& p,
                                        int t0, int bw, int nw, int lane) {
  const int col_groups = p.kpad / 32;
  const int items = col_groups * (L0_ROWS / 16);
  for (int g = bw; g < items; g += nw) {
    const int c = (g % col_groups) * 32 + lane, r0 = (g / col_groups) * 16;
    const bool col_ok = c < p.K;
    const int cc = col_ok ? c : 0;   // a padding column reads column 0
    const int j = static_cast<int>((static_cast<uint32_t>(cc) * p.fdiv) >> 20);
    const int w0 = r0 + j * p.dil;                 // window row of row r0
    const int s0 = t0 - p.left + w0;               // its frame
    const float* xr = xw + w0 * p.F + (cc - j * p.F);
    unsigned char* col = a + (c / 64) * A_CHUNK + r0 * 128 + (c % 8) * 2;
    const int unit = (c % 64) / 8;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // eight rows' loads before their stores: in flight together
      float v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int rr = 8 * h + q, s = s0 + rr;
        v[q] = col_ok && s >= 0 && s < p.T ? xr[rr * p.F] * mw[w0 + rr]
                                           : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q)   // row r0 + 8 h + q: r & 7 == q
        *reinterpret_cast<__nv_bfloat16*>(col + (8 * h + q) * 128 +
                                          ((unit ^ q) << 4)) =
            __float2bfloat16_rn(v[q]);
    }
  }
}

// The layer-0 kernel's epilogue: stage_half's for both 64-row halves of a
// consumer's tile, with each column pair's bias, scale, shift and slope
// read once (as float2) from the block's resident vectors, vecs[q * vec_cols
// + c], for the eight values of the pair.
template <int E>
__device__ __forceinline__ void stage_tile(const float (&acc0)[64],
                                           const float (&acc1)[64], int pass,
                                           unsigned char* out,
                                           const float* vecs, int vec_cols,
                                           int n0, const float (&m)[2][2],
                                           int act, float lrelu_alpha,
                                           int warp, int lane) {
  using C = Cfg<E>;
  constexpr int I_PER_PASS = 16 / C::PASSES;   // 8-column groups a pass
#pragma unroll
  for (int ii = 0; ii < I_PER_PASS; ++ii) {
    const int i = pass * I_PER_PASS + ii;
    const int col = 8 * i + 2 * (lane % 4);
    const float* v = vecs + n0 + col;
    const float2 bias = *reinterpret_cast<const float2*>(v);
    const float2 scale = *reinterpret_cast<const float2*>(v + vec_cols);
    const float2 shift = *reinterpret_cast<const float2*>(v + 2 * vec_cols);
    const float2 slope =
        act == PRELU ? *reinterpret_cast<const float2*>(v + 3 * vec_cols)
                     : make_float2(lrelu_alpha, lrelu_alpha);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float(&acc)[64] = half ? acc1 : acc0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 64 * half + 16 * warp + lane / 4 + 8 * h;
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = acc[4 * i + 2 * h + e] + (e ? bias.y : bias.x);
          const float sl = e ? slope.y : slope.x;
          const float r = act == RELU ? fmaxf(a, 0.0f)
                                      : fmaxf(a, 0.0f) + sl * fminf(a, 0.0f);
          y[e] = (r * (e ? scale.y : scale.x) + (e ? shift.y : shift.x)) *
                 m[half][h];
        }
        if constexpr (E == TDNN_F32) {
          const int lc = col - 64 * pass, cc = lc % 32;
          const uint32_t off = (lc / 32) * OUT_BOX + row * 128 +
                               (((cc / 4) ^ (row & 7)) * 16) + (cc % 4) * 4;
          *reinterpret_cast<float2*>(out + off) = make_float2(y[0], y[1]);
        } else {
          const uint32_t off = (i / 8) * OUT_BOX + row * 128 +
                               (((i % 8) ^ (row & 7)) * 16) + (lane % 4) * 4;
          *reinterpret_cast<__nv_bfloat162*>(out + off) =
              __floats2bfloat162_rn(y[0], y[1]);
        }
      }
    }
  }
}

template <int E>
__global__ void __launch_bounds__(THREADS, 1)
    tdnn_l0_sm90_kernel(const __grid_constant__ CUtensorMap mw,
                        const __grid_constant__ CUtensorMap mo,
                        const __grid_constant__ L0Params p) {
  using C = Cfg<E>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  const int a_tile = p.chunks * A_CHUNK;
  const uint32_t ring = base + p.n_abuf * a_tile;
  unsigned char* win = smem + p.n_abuf * a_tile + p.stages * W_STAGE;
  float* win_x = reinterpret_cast<float*>(win);
  float* win_m = win_x + p.x_blocks * WIN_BLOCK;
  float* vecs = reinterpret_cast<float*>(
      win + (p.x_blocks + p.m_blocks) * WIN_BLOCK * 4);
  unsigned char* outs = reinterpret_cast<unsigned char*>(
      vecs + 4 * p.vec_cols);
  const uint32_t bars = smem_u32(outs) + 2 * OUT;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (p.stages + s); };
  auto turn = [&](int w) { return bars + 8 * (2 * p.stages + w); };
  // a_full(i): A tile i is built; a_empty(i): both consumers are done with
  // it
  auto a_full = [&](int i) { return bars + 8 * (2 * p.stages + 2 + i); };
  auto a_empty = [&](int i) {
    return bars + 8 * (2 * p.stages + 2 + p.n_abuf + i);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);   // the four warps of the consuming group
    }
    mbar_init(turn(0), 1);
    mbar_init(turn(1), 1);
    for (int i = 0; i < p.n_abuf; ++i) {
      mbar_init(a_full(i), BUILDERS);   // every builder thread
      mbar_init(a_empty(i), 8);         // every consumer warp
    }
    mbar_fence_init();
  }
  const int tid_b = threadIdx.x - 256 - 32;   // builder thread, 0..95
  auto fill = [&](int mt) {
    const int s_lo = (mt / p.nt) * p.T + (mt % p.nt) * L0_ROWS - p.left;
    fill_window(win_x, p.x, s_lo * p.F, p.win_rows * p.F, p.B * p.T * p.F,
                tid_b);
    fill_window(win_m, p.mask, s_lo, p.win_rows, p.B * p.T, tid_b);
  };
  if (threadIdx.x >= 256 + 32) fill(blockIdx.x);   // the first window
  // bias, scale, shift and alpha for every column, once per block (zeros
  // past cout; alpha zeros but for prelu)
  for (int e = threadIdx.x; e < 4 * p.vec_cols; e += THREADS) {
    const int q = e / p.vec_cols, c = e % p.vec_cols;
    const float* src = q == 0 ? p.bias : q == 1 ? p.scale
                     : q == 2 ? p.shift : p.alpha;
    vecs[e] = c < p.cout && (q < 3 || p.act == PRELU) ? src[c] : 0.0f;
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producers: warp 8 streams W0 by TMA, warps 9-11 build A (with
    // more registers than v5's producer keeps, for loads in flight) ----
    setmaxnreg_dec<56>();
    const int warp = (threadIdx.x - 256) / 32, lane = threadIdx.x % 32;
    if (warp == 0) {
      if (lane == 0) {
        // every (row tile, Cout tile) of this block in order, W0's column
        // tile in `chunks` stages of 64 rows
        int it = 0;
        for (int mt = blockIdx.x; mt < p.row_tiles; mt += gridDim.x)
          for (int n = 0; n < p.n_tiles; ++n)
            for (int c = 0; c < p.chunks; ++c, ++it) {
              const int s = it % p.stages;
              mbar_wait(empty(s), ((it / p.stages) & 1) ^ 1);
              mbar_arrive_expect_tx(full(s), W_STAGE);
              const uint32_t st = ring + s * W_STAGE;
              tma_load_3d(&mw, full(s), st, n * BN, c * 64, 0);
              tma_load_3d(&mw, full(s), st + W_BOX, n * BN + 64, c * 64, 0);
            }
      }
    } else {
      // A row tile's window (its frames and their mask) is copied in by
      // cp.async as soon as the last one is free, so the copy overlaps the
      // wait for an A tile; then A is built from it.  The block's first A
      // tile, which nothing can overlap, is built by the consumer warps too
      int i = 0;
      for (int mt = blockIdx.x; mt < p.row_tiles; mt += gridDim.x, ++i) {
        cp_async_wait_all();
        const int buf = i % p.n_abuf;
        if (i == 0) {
          named_bar_sync(4, 256 + BUILDERS);   // the window is in
          build_a(smem, win_x, win_m, p, (mt % p.nt) * L0_ROWS, 7 + warp,
                  11, lane);
          fence_proxy_async();
          named_bar_sync(4, 256 + BUILDERS);   // A is built, the window free
        } else {
          named_bar_sync(3, BUILDERS);   // the window is in
          mbar_wait(a_empty(buf), ((i / p.n_abuf) & 1) ^ 1);
          build_a(smem + buf * a_tile, win_x, win_m, p,
                  (mt % p.nt) * L0_ROWS, warp - 1, 3, lane);
          fence_proxy_async();   // generic writes before wgmma's reads
          named_bar_sync(3, BUILDERS);   // the window is free again
        }
        mbar_arrive(a_full(buf));
        if (mt + gridDim.x < p.row_tiles) fill(mt + gridDim.x);
      }
    }
    return;
  }

  // ---- consumers: v5's ping-pong over the block's (row tile, Cout tile)
  // sequence q = i * n_tiles + n, WG w taking q = w, w + 2, ...; A stays
  // in shared memory for all n_tiles Cout tiles of its row tile ----
  setmaxnreg_inc<224>();
  const int wtid = threadIdx.x % 128, lane = wtid % 32, warp = wtid / 32;
  const uint32_t bar_id = 1 + wg;
  unsigned char* out_smem = outs + wg * OUT;
  const uint32_t out_base = smem_u32(out_smem);
  // the block's first A tile, with the builders (warps 0-7 of 11)
  named_bar_sync(4, 256 + BUILDERS);
  build_a(smem, win_x, win_m, p, (blockIdx.x % p.nt) * L0_ROWS,
          threadIdx.x / 32, 11, lane);
  fence_proxy_async();
  named_bar_sync(4, 256 + BUILDERS);
  int turns = 0, i = 0;
  for (int mt = blockIdx.x; mt < p.row_tiles; mt += gridDim.x, ++i) {
    const int buf = i % p.n_abuf;
    const int b = mt / p.nt, t0 = (mt % p.nt) * L0_ROWS;
    const uint32_t a_base = base + buf * a_tile;
    const int n_first = ((i * p.n_tiles) & 1) == wg ? 0 : 1;
    // this thread's four rows of the tile: frames t0 + 64 half + 16 warp +
    // lane / 4 + 8 h
    float m[2][2];
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + 64 * half + 16 * warp + lane / 4 + 8 * h;
        m[half][h] =
            t < p.T ? p.mask[static_cast<size_t>(b) * p.T + t] : 0.0f;
      }
    mbar_wait(a_full(buf), (i / p.n_abuf) & 1);
    for (int n = n_first; n < p.n_tiles; n += 2) {
      const int n0 = n * BN;
      int it = (i * p.n_tiles + n) * p.chunks;
      mbar_wait(turn(wg), (turns & 1) ^ (wg == 0));
      float acc0[64], acc1[64];
#pragma unroll
      for (int r = 0; r < 64; ++r) {
        acc0[r] = 0.0f;
        acc1[r] = 0.0f;
      }
      for (int step = 0; step < p.chunks; ++step, ++it) {
        const int s = it % p.stages;
        mbar_wait(full(s), (it / p.stages) & 1);
        const uint32_t st = ring + s * W_STAGE;
        const uint32_t at = a_base + step * A_CHUNK;
        fence_regs(acc0);
        fence_regs(acc1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t db = desc_sw128(st + kk * 2048, W_BOX, 1024);
          wgmma_m64n128<0, 1>(acc0, desc_sw128(at + kk * 32, 16, 1024), db);
          wgmma_m64n128<0, 1>(acc1, desc_sw128(at + 64 * 128 + kk * 32, 16,
                                               1024), db);
        }
        wgmma_commit();
        fence_regs(acc0);
        fence_regs(acc1);
        wgmma_wait<1>();
        fence_regs(acc0);
        fence_regs(acc1);
        if (step > 0 && lane == 0) mbar_arrive(empty((it - 1) % p.stages));
      }
      if (wtid == 0) mbar_arrive(turn(wg ^ 1));
      wgmma_wait<0>();
      fence_regs(acc0);
      fence_regs(acc1);
      if (lane == 0) {
        mbar_arrive(empty((it - 1) % p.stages));
        if (n + 2 >= p.n_tiles) mbar_arrive(a_empty(buf));   // A's last use
      }
      ++turns;

      // ---- epilogue: into swizzled shared memory, then TMA ----
#pragma unroll
      for (int pass = 0; pass < C::PASSES; ++pass) {
        if (wtid == 0) bulk_wait_read<0>();   // our last store has read
        named_bar_sync(bar_id, 128);
        stage_tile<E>(acc0, acc1, pass, out_smem, vecs, p.vec_cols, n0, m,
                      p.act, p.lrelu_alpha, warp, lane);
        fence_proxy_async();
        named_bar_sync(bar_id, 128);
        if (wtid == 0) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int c0 = n0 + pass * 64 + q * C::BOX_COLS;
            if (c0 < p.out_cols)
              tma_store_3d(&mo, out_base + q * OUT_BOX, c0, t0, b);
          }
          bulk_commit();
        }
      }
    }
    // a row tile with none of this group's tiles: done with it at once
    if (n_first >= p.n_tiles && lane == 0) mbar_arrive(a_empty(buf));
  }
  if (wtid == 0) bulk_wait<0>();
}

// Shared memory of the layer-0 kernel: A tiles, W stages, the window, the
// resident vectors, the two consumers' staging, then the barriers.  Two A
// tiles when they fit beside two W stages (k * F <= 128 at most: the
// recipe's 5 x 23), else one; as many W stages as are left, up to 4.
// Returns the bytes, or 0 when even one A tile and two stages do not fit
// (ops/tdnn_kernel.py:l0_takes makes the same count).
int l0_smem(L0Params* p) {
  const int a_tile = p->chunks * A_CHUNK;
  const int fixed = ALIGN + (p->x_blocks + p->m_blocks) * WIN_BLOCK * 4 +
                    16 * p->vec_cols + 2 * OUT + 8 * 16;   // <= 14 barriers
  const int avail = L0_SMEM - fixed;
  p->n_abuf = 2 * a_tile + 2 * W_STAGE <= avail ? 2 : 1;
  const int stages = (avail - p->n_abuf * a_tile) / W_STAGE;
  p->stages = stages < 4 ? stages : 4;
  if (p->stages < 2) return 0;
  return fixed + p->n_abuf * a_tile + p->stages * W_STAGE;
}

template <int E>
int l0_launch(const void* w0, void* out, int blocks, L0Params p,
              cudaStream_t stream) {
  static const int attr = static_cast<int>(cudaFuncSetAttribute(
      tdnn_l0_sm90_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L0_SMEM));
  if (attr != 0) return attr;
  const int smem = l0_smem(&p);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mw, mo;
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // W0 (kpad, cout) as it lies, entered as v5 enters W[j] (MN-major)
  int rc = make_map_3d(&mw, bf, 2, w0, p.cout, p.kpad, 1, 64, 64, 1,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0) {
    if (E == TDNN_F32)
      rc = make_map_3d(&mo, f32, 4, out, p.out_cols, p.T, p.B, 32, L0_ROWS,
                       1, CU_TENSOR_MAP_SWIZZLE_128B);
    else
      rc = make_map_3d(&mo, bf, 2, out, p.out_cols, p.T, p.B, 64, L0_ROWS, 1,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (rc != 0) return rc;
  const int grid = blocks < p.row_tiles ? blocks : p.row_tiles;
  tdnn_l0_sm90_kernel<E><<<grid, THREADS, smem, stream>>>(mw, mo, p);
  return static_cast<int>(cudaGetLastError());
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

// K1 v5, one eval TDNN layer: out (B, T, out_cols), bf16 or, with
// out_f32 != 0, f32, from x (B, T, Cin) bf16, w (K, Cin, Cout) bf16, the
// f32 (Cout) vectors bias, scale, shift and (prelu only; may be null
// otherwise) alpha, and the f32 (B, T) row mask.  act: 0 relu, 1 lrelu
// (slope lrelu_alpha), 2 prelu.  Cin and Cout must be multiples of 8 (the
// fold zero-pads W's columns and the vectors to one); out takes the first
// out_cols <= Cout columns, and its rows must be multiples of 16 bytes
// (etdnn's 1500 f32 columns: 6000 bytes).  Returns 0, a cudaError_t, or an
// sm90::ERR_* code.
int tdnn_layer_sm90_launch(const void* x, const void* mask, const void* w,
                           const void* bias, const void* scale,
                           const void* shift, const void* alpha, void* out,
                           int out_f32, int blocks, int B, int T, int cin,
                           int cout, int out_cols, int k, int dil, int act,
                           float lrelu_alpha, void* stream) {
  if (act < RELU || act > PRELU || (act == PRELU && alpha == nullptr) ||
      out_cols < 1 || out_cols > cout)
    return static_cast<int>(cudaErrorInvalidValue);
  FwdParams p = shape(B, T, cout, k, dil);
  p.out_cols = out_cols;
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

// K1 layer 0 on Hopper: out (B, T, out_cols), bf16 or, with out_f32 != 0,
// f32, from the f32 features x (B, T, F) and (B, T) mask, W0 packed as
// (kpad, cout) bf16 in (tap, channel) row order (row j * F + ch is W[j][ch],
// rows K = k * F .. kpad zero; kpad = K rounded up to 64), and the f32
// (cout) vectors as tdnn_layer_sm90_launch takes them.  cout must be a
// multiple of 8, out's rows multiples of 16 bytes, and A, the window and
// two W stages must fit (l0_smem; k * F <= 320 at k = 5).  Returns 0, a
// cudaError_t, or an sm90::ERR_* code.
int tdnn_l0_sm90_launch(const void* x, const void* mask, const void* w0,
                        const void* bias, const void* scale,
                        const void* shift, const void* alpha, void* out,
                        int out_f32, int blocks, int B, int T, int F,
                        int kpad, int cout, int out_cols, int k, int dil,
                        int act, float lrelu_alpha, void* stream) {
  if (act < RELU || act > PRELU || (act == PRELU && alpha == nullptr) ||
      out_cols < 1 || out_cols > cout || cout % 8 || F < 1 || k < 1 ||
      dil < 1 || kpad % 64 || kpad < k * F || B < 1 || T < 1 ||
      static_cast<int64_t>(B) * (T + (k - 1) * dil) * F >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  L0Params p = {};
  p.x = static_cast<const float*>(x);
  p.mask = static_cast<const float*>(mask);
  p.bias = static_cast<const float*>(bias);
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.alpha = static_cast<const float*>(alpha);
  p.B = B;
  p.T = T;
  p.F = F;
  p.K = k * F;
  p.kpad = kpad;
  p.k = k;
  p.dil = dil;
  p.left = (k - 1) / 2 * dil;
  p.fdiv = ((1u << 20) + F - 1) / F;
  p.cout = cout;
  p.out_cols = out_cols;
  p.nt = (T + L0_ROWS - 1) / L0_ROWS;
  p.row_tiles = B * p.nt;
  p.n_tiles = (cout + BN - 1) / BN;
  p.chunks = kpad / 64;
  p.win_rows = L0_ROWS + (k - 1) * dil;
  p.x_blocks = (p.win_rows * F + WIN_BLOCK - 1) / WIN_BLOCK;
  p.m_blocks = (p.win_rows + WIN_BLOCK - 1) / WIN_BLOCK;
  p.vec_cols = (cout + BN - 1) / BN * BN;
  p.act = act;
  p.lrelu_alpha = lrelu_alpha;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_f32) return l0_launch<TDNN_F32>(w0, out, blocks, p, s);
  return l0_launch<TDNN_BF16>(w0, out, blocks, p, s);
}

}  // extern "C"
