// Weight gradient (K3) and input gradient (K4) of the SAME 1-D convolution
// of the wide TDNN layers, written for Hopper's own instructions: wgmma,
// TMA tile loads and stores with mbarriers, and warp specialisation.
//
// Replaces two TPU kernels of xvector_tpu/ops/conv_bwd.py (the backward of
// its custom VJP conv1d_same_fused_bwd), with x (B, T, Cin), W (K, Cin,
// Cout), the cotangent g (B, T, Cout), left = (K-1)/2*d and zeros outside
// [0, T) of each batch row:
//
//   K3 _pallas_dw (conv_bwd.py:174, body _dw_kernel):
//       dW[j] = sum_{b,t} x[b, t - left + j*d]^T g[b, t]   f32 (K*Cin, Cout)
//   K4 _pallas_dx (conv_bwd.py:201, body _dx_kernel):
//       dx[b,t] = sum_j g[b, t + left - j*d] W[j]^T        bf16 (B, T, Cin)
//
// Operands are bf16; every product of a call is summed in f32 and rounded
// once (dx to bf16; dW stays f32).
//
// What bounds them on this card: operations.  At the training working
// point (64 x 304 frames, 512 -> 512 channels) a k=5 call is 5.1e10 FLOP
// against ~43 MB of compulsory traffic, ~1200 FLOP/byte, four times the
// H100's bf16 balance point (~295 FLOP/byte).  So the design keeps the
// tensor cores fed and moves every operand byte with TMA:
//
// * One producer warp issues TMA box loads into a ring of shared-memory
//   stages (128-byte swizzle), each stage guarded by a "full" mbarrier
//   (bytes landed) and an "empty" one (both consumer warpgroups done).  Two
//   consumer warpgroups run wgmma m64nNk16 on the stages with f32
//   accumulators in registers; setmaxnreg moves registers from the
//   producer's warpgroup (40) to theirs (232).
// * The tap shift is a TMA coordinate.  x and g are mapped as 3-D tensors
//   (C, T, B), innermost first; tap j of a tile loads at t0 + shift_j, and
//   the hardware zero-fills rows outside [0, T) and b >= B.  No row mask, no
//   division and no padded copy exists.  The k re-reads of a tile come from
//   L2.
// * Nothing is transposed.  Tiles stay in shared memory as they lie.
//
// K3 v2 (dw_sm90_kernel<BN>): the output (K*Cin, Cout) is tiled as taps x
//   128 channels of Cin by BN (128 or 256) of Cout, so a tile never
//   straddles two taps.  The contraction runs over (b, t) in stages of
//   4 batch rows x 16 frames = 64 rows; x (A) and g (B) both enter wgmma
//   MN-major (channels contiguous), as TMA wrote them.  The output has few
//   tiles (40 or 80 at k=5), so the B*T contraction is split into S
//   balanced ranges of stages, run by the S blocks of one thread-block
//   cluster (grid z).  Each block keeps its f32 partial in its own shared
//   memory; after a cluster barrier, block r sums 8-row groups g with
//   g % S == r over the S partials in rank order, through distributed
//   shared memory, and writes each group once with a TMA store through an
//   f32 (Cout, Cin, K) map that clips the edges.  One launch, no workspace
//   in device memory, and the same bits on every run (no atomics, no
//   reduce-add: their order changes between runs).  The schedule (BN, S)
//   comes from ops/conv_bwd.py:dw_schedule.
// K4 v2 (dx_sm90_kernel): output rows are (b, t) tiles of 8 batch rows x 16
//   frames = 128 by 128 channels of Cin; the contraction runs over
//   (tap j, 64 channels of Cout).  A is g through a (Cout, T, B) map at
//   t0 + left - j*d, K-major; B is W[j]^T through a (Cout, Cin, K) map over
//   W as it lies (box 64 co x 128 ci x 1 tap), the canonical K-major B.
//   The grid is persistent: one block per SM walks the tile list
//   tile = blockIdx.x + i * gridDim.x (Cin tiles fastest, so neighbours
//   share g rows in L2), and the producer runs ahead into the next tile
//   while the consumers round the last one to bf16 into swizzled shared
//   memory and TMA-store it through a (Cin, T, B) map that clips t >= T and
//   b >= B.  That overlaps each epilogue with the next tile's loads and
//   spreads v1's 30%-full last wave over every SM.
//
// Shapes: every channel count a multiple of 8 (TMA's 16-byte global
// strides); ops/conv_bwd.py:route sends the rest to conv_bwd.cu.  Each
// launch function encodes its tensor maps on the host (libcuda's
// cuTensorMapEncodeTiled, reached through the runtime) and passes them as
// __grid_constant__ parameters.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int THREADS = 384;         // WG0, WG1: consumers; WG2: producer
constexpr int CONSUMERS = 256;
constexpr int PRODUCER = 256;        // the thread that issues TMA
constexpr uint32_t EPI_BAR = 1;      // named barrier of the consumers
constexpr int BOX = 64 * 128;        // 64 rows of 128 bytes (64 bf16)
constexpr int RING = 192 * 1024;     // pipeline ring (K3: also the partial)
constexpr int ALIGN = 1024;          // 128-byte swizzle atoms

__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((ALIGN - (a & (ALIGN - 1))) & (ALIGN - 1));
}

// ---------------------------------------------------------------------------
// K3 v2
// ---------------------------------------------------------------------------

constexpr int DW_BM = 128;           // (j, ci) rows per tile: 64 per WG
constexpr int DW_TT = 16, DW_BB = 4; // stage: 16 frames x 4 batch rows

template <int BN>
struct Dw {
  static constexpr int STAGE = (2 + BN / 64) * BOX;   // A: 2 boxes, B: BN/64
  static constexpr int STAGES = RING / STAGE;         // 4 (256) or 6 (128)
  static constexpr int PART = DW_BM * BN * 4;         // f32 partial tile
  static constexpr int GROUP = 8 * BN * 4;            // 8 output rows, f32
  static constexpr int SMEM = ALIGN + RING + 2 * STAGES * 8;
  static_assert(PART + 2 * GROUP <= RING, "partial and staging fit the ring");
};

struct DwParams {
  int cin, dil, left;
  int steps;    // ceil(B / DW_BB) * nt contraction stages
  int nt;       // ceil(T / DW_TT)
  int mct;      // ceil(Cin / DW_BM) row tiles per tap
  int splits;   // S, the cluster size along z
};

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    dw_sm90_kernel(const __grid_constant__ CUtensorMap mx,
                   const __grid_constant__ CUtensorMap mg,
                   const __grid_constant__ CUtensorMap mo, DwParams p) {
  using C = Dw<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + RING;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (C::STAGES + s); };

  const int n0 = blockIdx.x * BN;
  const int j = blockIdx.y / p.mct;
  const int ci0 = (blockIdx.y % p.mct) * DW_BM;
  const int rank = static_cast<int>(cluster_ctarank());
  const int r0 = static_cast<int>(static_cast<long long>(rank) * p.steps /
                                  p.splits);
  const int r1 = static_cast<int>(static_cast<long long>(rank + 1) *
                                  p.steps / p.splits);

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer ----
    setmaxnreg_dec<40>();
    if (threadIdx.x == PRODUCER) {
      const int shift = j * p.dil - p.left;
      for (int i = r0; i < r1; ++i) {
        const int it = i - r0, s = it % C::STAGES;
        mbar_wait(empty(s), ((it / C::STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(full(s), C::STAGE);
        const int b0 = (i / p.nt) * DW_BB, t0 = (i % p.nt) * DW_TT;
        const uint32_t st = base + s * C::STAGE;
        tma_load_3d(&mx, full(s), st, ci0, t0 + shift, b0);
        tma_load_3d(&mx, full(s), st + BOX, ci0 + 64, t0 + shift, b0);
#pragma unroll
        for (int q = 0; q < BN / 64; ++q)
          tma_load_3d(&mg, full(s), st + (2 + q) * BOX, n0 + 64 * q, t0, b0);
      }
    }
    __syncwarp();
    cluster_sync();   // the partials are in shared memory
    cluster_sync();   // every block has read them
    return;
  }

  // ---- consumers: WG w owns rows (j, ci0 + 64w .. +64) of the tile ----
  setmaxnreg_inc<232>();
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

  for (int it = 0; it < r1 - r0; ++it) {
    const int s = it % C::STAGES;
    mbar_wait(full(s), (it / C::STAGES) & 1);
    const uint32_t st = base + s * C::STAGE;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {   // 16 contraction rows each
      const uint64_t da = desc_sw128(st + wg * BOX + kk * 2048, BOX, 1024);
      const uint64_t db = desc_sw128(st + 2 * BOX + kk * 2048, BOX, 1024);
      if constexpr (BN == 256)
        wgmma_m64n256<1, 1>(acc, da, db);
      else
        wgmma_m64n128<1, 1>(acc, da, db);
    }
    wgmma_commit();
    fence_regs(acc);
    wgmma_wait<1>();   // the previous stage's products are done
    fence_regs(acc);
    if (it > 0 && threadIdx.x % 128 == 0)
      mbar_arrive(empty((it - 1) % C::STAGES));
  }
  wgmma_wait<0>();
  fence_regs(acc);
  named_bar_sync(EPI_BAR, CONSUMERS);   // both WGs are off the ring

  // f32 partial, [128 rows][BN], 16-byte chunks swizzled by row % 8
  float* part = reinterpret_cast<float*>(smem);
  const int lane = threadIdx.x % 32;
  const int wrow = wg * 64 + (threadIdx.x % 128) / 32 * 16;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wrow + lane / 4 + 8 * h;
      const int col = 8 * i + 2 * (lane % 4);
      const int chunk = (col / 4) ^ (row & 7);
      *reinterpret_cast<float2*>(part + row * BN + chunk * 4 + col % 4) =
          make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
    }
  }
  cluster_sync();

  // ordered sum over the S partials, 8-row groups g with g % S == rank
  const int ctid = threadIdx.x;
  float* staging = reinterpret_cast<float*>(smem + C::PART);
  int q = 0;
  for (int grp = rank; grp < DW_BM / 8; grp += p.splits, ++q) {
    const int row0 = grp * 8;
    if (ci0 + row0 >= p.cin) break;   // rows past Cin: nothing to write
    if (q >= 2 && ctid == 0) bulk_wait_read<1>();   // buffer q % 2 is free
    named_bar_sync(EPI_BAR, CONSUMERS);
    float* out = staging + (q & 1) * 8 * BN;
    for (int e = ctid; e < 8 * (BN / 4); e += CONSUMERS) {
      const int r = e / (BN / 4), c4 = e % (BN / 4), row = row0 + r;
      const uint32_t off =
          base + static_cast<uint32_t>(row * BN + ((c4 ^ (row & 7)) * 4)) * 4;
      float4 sum = ld_cluster_f4(map_rank(off, 0));
      for (int rr = 1; rr < p.splits; ++rr) {
        const float4 v = ld_cluster_f4(map_rank(off, rr));
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      *reinterpret_cast<float4*>(out + r * BN + c4 * 4) = sum;
    }
    fence_proxy_async();
    named_bar_sync(EPI_BAR, CONSUMERS);
    if (ctid == 0) {
      tma_store_3d(&mo, smem_u32(out), n0, ci0 + row0, j);
      bulk_commit();
    }
  }
  if (ctid == 0) bulk_wait<0>();
  cluster_sync();
}

// ---------------------------------------------------------------------------
// K4 v2
// ---------------------------------------------------------------------------

constexpr int DX_TT = 16, DX_BB = 8;   // output rows per tile: 8 x 16 = 128
constexpr int DX_BN = 128;             // Cin columns per tile
constexpr int DX_A = 128 * 128;        // 128 rows x 64 co, bf16
constexpr int DX_B = DX_BN * 128;      // 128 ci x 64 co, bf16
constexpr int DX_STAGE = DX_A + DX_B;
constexpr int DX_STAGES = 5;
constexpr int DX_OUT = 128 * DX_BN * 2;   // bf16 tile, two 64-column halves
constexpr int DX_SMEM = ALIGN + DX_STAGES * DX_STAGE + DX_OUT +
                        2 * DX_STAGES * 8;

struct DxParams {
  int cin, k, dil, left;
  int nt;        // ceil(T / DX_TT)
  int n_tiles;   // ceil(Cin / DX_BN)
  int tiles;     // ceil(B / DX_BB) * nt * n_tiles
  int nco;       // ceil(Cout / 64)
};

__global__ void __launch_bounds__(THREADS, 1)
    dx_sm90_kernel(const __grid_constant__ CUtensorMap mg,
                   const __grid_constant__ CUtensorMap mw,
                   const __grid_constant__ CUtensorMap mo, DxParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t out_base = base + DX_STAGES * DX_STAGE;
  const uint32_t bars = out_base + DX_OUT;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (DX_STAGES + s); };
  const int steps = p.k * p.nco;

  if (threadIdx.x == 0) {
    for (int s = 0; s < DX_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);
    }
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
        const int mt = tile / p.n_tiles, n0 = (tile % p.n_tiles) * DX_BN;
        const int b0 = (mt / p.nt) * DX_BB, t0 = (mt % p.nt) * DX_TT;
        for (int step = 0; step < steps; ++step, ++it) {
          const int j = step / p.nco, co0 = (step % p.nco) * 64;
          const int s = it % DX_STAGES;
          mbar_wait(empty(s), ((it / DX_STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(full(s), DX_STAGE);
          const uint32_t st = base + s * DX_STAGE;
          tma_load_3d(&mg, full(s), st, co0, t0 + p.left - j * p.dil, b0);
          tma_load_3d(&mw, full(s), st + DX_A, co0, n0, j);
        }
      }
    }
    return;
  }

  // ---- consumers: WG w owns output rows 64w .. 64w + 63 of each tile ----
  setmaxnreg_inc<232>();
  const int ctid = threadIdx.x;
  const int lane = ctid % 32, wrow = wg * 64 + (ctid % 128) / 32 * 16;
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int mt = tile / p.n_tiles, n0 = (tile % p.n_tiles) * DX_BN;
    const int b0 = (mt / p.nt) * DX_BB, t0 = (mt % p.nt) * DX_TT;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    for (int step = 0; step < steps; ++step, ++it) {
      const int s = it % DX_STAGES;
      mbar_wait(full(s), (it / DX_STAGES) & 1);
      const uint32_t st = base + s * DX_STAGE;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {   // 16 channels of Cout = 32 bytes
        const uint64_t da = desc_sw128(st + wg * 64 * 128 + kk * 32, 16, 1024);
        const uint64_t db = desc_sw128(st + DX_A + kk * 32, 16, 1024);
        wgmma_m64n128<0, 0>(acc, da, db);
      }
      wgmma_commit();
      fence_regs(acc);
      wgmma_wait<1>();
      fence_regs(acc);
      if (step > 0 && ctid % 128 == 0)
        mbar_arrive(empty((it - 1) % DX_STAGES));
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (ctid % 128 == 0) mbar_arrive(empty((it - 1) % DX_STAGES));

    // epilogue: bf16 into two swizzled [128 rows][64 ci] halves, then TMA
    if (ctid == 0) bulk_wait_read<0>();   // the last tile's store has read
    named_bar_sync(EPI_BAR, CONSUMERS);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wrow + lane / 4 + 8 * h;
        const uint32_t off = (i / 8) * (128 * 128) + row * 128 +
                             (((i % 8) ^ (row & 7)) * 16) + (lane % 4) * 4;
        *reinterpret_cast<__nv_bfloat162*>(smem + DX_STAGES * DX_STAGE +
                                           off) =
            __floats2bfloat162_rn(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
      }
    }
    fence_proxy_async();
    named_bar_sync(EPI_BAR, CONSUMERS);
    if (ctid == 0) {
      tma_store_3d(&mo, out_base, n0, t0, b0);
      if (n0 + 64 < p.cin)
        tma_store_3d(&mo, out_base + 128 * 128, n0 + 64, t0, b0);
      bulk_commit();
    }
  }
  if (ctid == 0) bulk_wait<0>();
}

template <typename Kern>
int allow_smem(Kern kern, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int BN>
int dw_allow_smem() {
  static const int attr = allow_smem(dw_sm90_kernel<BN>, Dw<BN>::SMEM);
  return attr;
}

cudaLaunchAttribute cluster_z(int splits) {
  cudaLaunchAttribute a;
  a.id = cudaLaunchAttributeClusterDimension;
  a.val.clusterDim.x = 1;
  a.val.clusterDim.y = 1;
  a.val.clusterDim.z = splits;
  return a;
}

template <int BN>
int dw_max_clusters(int splits, int* out) {
  const int attr = dw_allow_smem<BN>();
  if (attr != 0) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, 1, splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Dw<BN>::SMEM;
  cudaLaunchAttribute attrs[1] = {cluster_z(splits)};
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      out, dw_sm90_kernel<BN>, &cfg));
}

template <int BN>
int dw_launch(const void* x, const void* g, void* dw, int splits, int B,
              int T, int cin, int cout, int k, int dil, cudaStream_t stream) {
  using C = Dw<BN>;
  const int attr = dw_allow_smem<BN>();
  if (attr != 0) return attr;
  CUtensorMap mx, mg, mo;
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  int rc = make_map_3d(&mx, bf, 2, x, cin, T, B, 64, DW_TT, DW_BB,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0)
    rc = make_map_3d(&mg, bf, 2, g, cout, T, B, 64, DW_TT, DW_BB,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0)
    rc = make_map_3d(&mo, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, dw, cout, cin,
                     k, BN, 8, 1, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc != 0) return rc;
  DwParams p;
  p.cin = cin;
  p.dil = dil;
  p.left = (k - 1) / 2 * dil;
  p.nt = (T + DW_TT - 1) / DW_TT;
  p.steps = (B + DW_BB - 1) / DW_BB * p.nt;
  p.mct = (cin + DW_BM - 1) / DW_BM;
  p.splits = splits;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((cout + BN - 1) / BN, k * p.mct, splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1] = {cluster_z(splits)};
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, dw_sm90_kernel<BN>, mx, mg,
                                           mo, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K3 v2: dw (K, Cin, Cout) f32 from x (B, T, Cin) and g (B, T, Cout) bf16,
// in one cluster launch of `splits` (1..8) blocks per output tile of
// 128 x bn (bn 128 or 256).  Channel counts must be multiples of 8.
// Returns 0, a cudaError_t, or an sm90::ERR_* code.
int conv_dw_sm90_launch(const void* x, const void* g, void* dw, int bn,
                        int splits, int B, int T, int cin, int cout, int k,
                        int dil, void* stream) {
  if (splits < 1 || splits > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 256) return dw_launch<256>(x, g, dw, splits, B, T, cin, cout, k,
                                       dil, s);
  if (bn == 128) return dw_launch<128>(x, g, dw, splits, B, T, cin, cout, k,
                                       dil, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// How many clusters of `splits` K3 v2 blocks of width bn the card holds
// at once (cudaOccupancyMaxActiveClusters): one wave of the grid.  Writes
// it to *out; returns 0 or a cudaError_t.
int conv_dw_sm90_max_clusters(int bn, int splits, int* out) {
  if (splits < 1 || splits > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bn == 256) return dw_max_clusters<256>(splits, out);
  if (bn == 128) return dw_max_clusters<128>(splits, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K4 v2: dx (B, T, Cin) bf16 from g (B, T, Cout) and w (K, Cin, Cout) bf16,
// on a persistent grid of `blocks` blocks (at most one per SM).  Channel
// counts must be multiples of 8.  Returns 0, a cudaError_t, or an
// sm90::ERR_* code.
int conv_dx_sm90_launch(const void* g, const void* w, void* dx, int blocks,
                        int B, int T, int cin, int cout, int k, int dil,
                        void* stream) {
  static const int attr = allow_smem(dx_sm90_kernel, DX_SMEM);
  if (attr != 0) return attr;
  CUtensorMap mg, mw, mo;
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  int rc = make_map_3d(&mg, bf, 2, g, cout, T, B, 64, DX_TT, DX_BB,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0)
    rc = make_map_3d(&mw, bf, 2, w, cout, cin, k, 64, DX_BN, 1,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0)
    rc = make_map_3d(&mo, bf, 2, dx, cin, T, B, 64, DX_TT, DX_BB,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  DxParams p;
  p.cin = cin;
  p.k = k;
  p.dil = dil;
  p.left = (k - 1) / 2 * dil;
  p.nt = (T + DX_TT - 1) / DX_TT;
  p.n_tiles = (cin + DX_BN - 1) / DX_BN;
  p.tiles = (B + DX_BB - 1) / DX_BB * p.nt * p.n_tiles;
  p.nco = (cout + 63) / 64;
  const int grid = blocks < p.tiles ? blocks : p.tiles;
  dx_sm90_kernel<<<grid, THREADS, DX_SMEM, static_cast<cudaStream_t>(
                                              stream)>>>(mg, mw, mo, p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
