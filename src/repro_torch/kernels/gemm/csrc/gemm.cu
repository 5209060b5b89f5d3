// Planned GEMM for Hopper (sm_90a): out = epilogue(C? + A @ op(B)).
//
// Replaces the reference package's two TPU GEMM kernels
// (src/repro/kernels/gemm/kernel.py):
//   * gemm_fused  <- build_fused_gemm_kernel (_fused_kernel_body): one
//     launch walks a whole plan's tile table, one tile per table row,
//     batch as the second grid dimension;
//   * gemm_region <- build_gemm_kernel (_gemm_kernel_body): one launch per
//     plan region, writing straight into the full C (no operand slices,
//     no stitching).
// Both are thin __global__ entry points over one tile routine per (route,
// shape) that computes a BM x BN window of C and stores only the elements
// the tile owns, so every C element is stored by exactly one thread block.
//
// What bounds it on the H100 at the main-path shapes:
//   * prefill, training and every read-out at M >= 64 (e.g. Qwen3's
//     1024 x 151936 x 1024 training read-out): hundreds of flops per byte,
//     above the card's ~295 flop/byte ridge, so the tensor cores' 989
//     TFLOP/s -- and, with 128 x 128 tiles of 32-deep panels, the L2's
//     rate of feeding 16 KB a panel to every SM;
//   * decode, M <= 16: every weight byte is read once for 2 M flops, so
//     3.35 TB/s of HBM, and a grid of one block per 128 weight columns
//     (8-32 blocks for Qwen3's and phi3.5's projections) leaves most of
//     the 132 SMs idle.
// The bf16 routes (chosen per call in kernel.py, which counts them):
//   (A) bm 64 / 128: a ring of STAGES K panels (two blocks an SM) in
//       dynamic shared memory, filled by TMA from 3-D
//       tensor maps over (batch, rows, cols), so the hardware's
//       out-of-bounds zero fill masks every edge and no padding is read,
//       and completed on mbarriers.  One producer warp starts the loads
//       (64-row boxes of A, 64-row or 64-column boxes of B); one consumer
//       warpgroup per 64 rows runs wgmma m64nBNk16 with fp32
//       accumulators in registers and releases each stage as the next
//       one's products start.
//   (B) bm 16, the decode shape: the same ring, computed swap-AB (C^T =
//       B^T A^T: the weight columns fill wgmma's 64 rows, the <= 16
//       activation rows are its N = 16), so a 16-row window costs one
//       m64n16 product per 64 weight columns instead of a mostly masked
//       m64 one.  Where the plan has fewer tiles than the card has SMs,
//       kernel.py splits K over a thread-block cluster of up to MAX_CLUSTER
//       blocks; each block sums its share of the panels, and the partial
//       sums reach the cluster's leader through distributed shared memory
//       in rank order (deterministic).  The leader alone runs the epilogue
//       and stores.  The split applies to route A's tiles too.
//   (C) operands TMA cannot take (a base that is not 16-byte aligned, or a
//       row stride that is not a multiple of 16 bytes, e.g. K = 1001): all
//       threads load the next panel through registers, predicated with
//       zero fill, into a swizzled two-stage ring while the current one is
//       multiplied, feeding the same wgmma and epilogue code.  cp.async
//       is not usable there: it copies 4, 8 or 16 bytes from an address
//       aligned to that size, and such rows start on 2-byte boundaries.
// Every route stages the finished fp32 tile in the ring's shared memory
// and stores rows of eight owned columns with 16-byte accesses.  The bf16
// tile itself (the ring, routes A/B and C, the epilogue, the tensor maps)
// lives in wgmma_tile.cuh, which the grouped GEMM's forward shares.  Blocks
// take tiles in bands of RASTER_ROWS tile rows, a band column by column,
// so the blocks in flight share B's panels in L2 (a read-out's B is read
// from HBM about once, not once per tile row).
// fp32 operands keep register-blocked CUDA-core FMAs (never TF32).
//
// The epilogue runs on the fp32 accumulator: + C_in, + bias, activation
// (gelu is the tanh approximation), then the cast to the output type.
//
// gemm_act_bwd is the backward epilogue of an activation GEMM on the same
// bf16 tile: the pre-activation's product again, then
//   dpre = dy * act'(A @ op(B) + C_in + bias)
// with the cotangent dy (bf16 or fp32, (nb, m, n)) read the way C_in is,
// and dpre written once in the output type.  It replaces no TPU kernel:
// the reference's backward recomputes the product with XLA's dot on the
// bf16 operands, accumulating in fp32, as this does.  At the training
// shapes (e.g. phi3-mini's gate, 32768 x 8192 x 3072) it is the forward's
// product plus one read of dy and one write of dpre, so the tensor cores
// bound it as they bound the forward.  It walks the forward plan's tile
// table (gemm_fused's), on routes A, B and C; its kernel is a separate
// entry point (gemm_bf16_bwd_kernel) over the tile routines' GRAD variant,
// so the forward kernels compile as they did.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

#include "wgmma_tile.cuh"

namespace {

// The bf16 tile (its ring, routes, epilogue and tensor maps) is
// wgmma_tile.cuh's, shared with the grouped GEMM's forward.
using namespace wgt;

constexpr int NT = 128;       // threads per block of the fp32 route
constexpr int MAX_CLUSTER = 8;  // split-K blocks (H100_SXM.gemm_max_cluster)
constexpr int SMEM_BYTES = 2 * BK * (128 + 4) * 4;  // fp32 route, static
// A region's windows are taken in bands of RASTER_ROWS tile rows, a band
// column by column (the fused table comes in that order from kernel.py),
// so the blocks in flight share B's column panels in L2.
constexpr int RASTER_ROWS = 8;

enum { ROUTE_A = 0, ROUTE_B = 1, ROUTE_C = 2 };

// Where a block's tile comes from: a row of the fused kernel's tile table,
// or one window of a region's grid.  `split` blocks (a cluster) share a
// tile; `nwg` is the number of consumer warpgroups.
struct TileSrc {
  const int* table;   // (tiles, 8) rows, or null for a region
  const int* blocks;  // (block_id -> shape, bm_e, bn_e)
  int shape, row0, col0, rows, cols, tiles_r, tiles_c;  // the region
  int split, nwg;
};

// C_in joins the fp32 accumulator before bias and activation (ref_gemm's
// order).
__device__ __forceinline__ float finish_value(const GemmArgs& g, int64_t o,
                                              int col, float acc) {
  if (g.c) acc += load_f(g.c, g.c_dtype, o);
  return epilogue(acc, g, col);
}

// One output element of the tile, if the tile owns it.
__device__ __forceinline__ void finish(const GemmArgs& g, int batch, int r,
                                       int c, float acc, int r0, int r1,
                                       int c0, int c1) {
  if (r < r0 || r >= r1 || c < c0 || c >= c1) return;
  const int64_t o = (int64_t)batch * g.m * g.n + (int64_t)r * g.n + c;
  store_f(g.out, g.out_dtype, o, finish_value(g, o, c, acc));
}

// ---------------------------------------------------------------------------
// fp32: register-blocked fp32 FMAs (no TF32), 128 threads.
// ---------------------------------------------------------------------------

template <int BM, int BN>
__device__ __noinline__ void tile_f32(const GemmArgs g, int batch,
                                     int orow, int ocol, int r0, int r1,
                                     int c0, int c1, unsigned char* smem) {
  constexpr int LDSA = BM + 4;
  constexpr int LDSB = BN + 4;
  constexpr int TM = BM / 8, TN = BN / 16;
  float* As = reinterpret_cast<float*>(smem);  // BK x LDSA (A transposed)
  float* Bs = As + BK * LDSA;                  // BK x LDSB
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* A = reinterpret_cast<const float*>(g.a) + (int64_t)batch * g.m * g.k;
  const float* B = reinterpret_cast<const float*>(g.b) + (int64_t)batch * g.k * g.n;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < g.k; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK, kk = i % BK, gr = orow + r, gk = k0 + kk;
      As[kk * LDSA + r] =
          (gr < g.m && gk < g.k) ? A[(int64_t)gr * g.k + gk] : 0.f;
    }
    if (!g.nt) {
      for (int i = tid; i < BK * BN; i += NT) {
        const int kk = i / BN, cc = i % BN, gk = k0 + kk, gc = ocol + cc;
        Bs[kk * LDSB + cc] =
            (gk < g.k && gc < g.n) ? B[(int64_t)gk * g.n + gc] : 0.f;
      }
    } else {
      for (int i = tid; i < BK * BN; i += NT) {
        const int cc = i / BK, kk = i % BK, gk = k0 + kk, gc = ocol + cc;
        Bs[kk * LDSB + cc] =
            (gk < g.k && gc < g.n) ? B[(int64_t)gc * g.k + gk] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk * LDSA + ty + i * 8];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk * LDSB + tx + j * 16];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      finish(g, batch, orow + ty + i * 8, ocol + tx + j * 16, acc[i][j], r0,
             r1, c0, c1);
}

struct F32Route {
  template <int BM, int BN>
  static __device__ __forceinline__ void run(const Tile& t) {
    tile_f32<BM, BN>(t.g, t.batch, t.orow, t.ocol, t.r0, t.r1, t.c0, t.c1,
                     t.smem);
  }
};

// Route R's tile with the backward epilogue (wgmma_tile.cuh's GRAD).
template <typename R>
struct ActGrad {
  template <int BM, int BN>
  static __device__ __forceinline__ void run(const Tile& t, const Maps& m) {
    R::template run<BM, BN, true>(t, m);
  }
};

template <typename T, int BM, int BN>
__device__ __forceinline__ void tile(const Tile& t, const Maps& m) {
  if constexpr (std::is_same<T, F32Route>::value)
    T::template run<BM, BN>(t);
  else
    T::template run<BM, BN>(t, m);
}

// The palette, in the order kernel.py's TEMPLATE_SHAPES lists it.  Each
// (route, shape) tile routine is compiled once and shared by both entry
// points.
__host__ __device__ inline int shape_bm(int shape) {
  return shape < 2 ? 16 : shape < 4 ? 64 : 128;
}
__host__ __device__ inline int shape_bn(int shape) {
  return shape % 2 ? 128 : 64;
}

template <typename T>
__device__ __forceinline__ void tile_by_shape(int shape, const Tile& t,
                                              const Maps& m) {
  switch (shape) {
    case 0: tile<T, 16, 64>(t, m); break;
    case 1: tile<T, 16, 128>(t, m); break;
    case 2: tile<T, 64, 64>(t, m); break;
    case 3: tile<T, 64, 128>(t, m); break;
    case 4: tile<T, 128, 64>(t, m); break;
    case 5: tile<T, 128, 128>(t, m); break;
    default: break;
  }
}

// The block's tile.  Fused: table row blockIdx.x / split, (row0, col0,
// row_end, col_end, rs, cs, block_id, scale_idx); the window sits at the
// clamped origin (rs, cs) and blocks[3 * block_id] names its shape.
// Region: window blockIdx.x / split of the region's grid, in bands of
// RASTER_ROWS tile rows, each band column by column.
// blockIdx.y is the batch; a cluster's blocks are consecutive in x.
__device__ __forceinline__ int resolve_tile(const TileSrc& src, Tile& t) {
  const int tile = blockIdx.x / src.split;
  t.batch = t.bbatch = blockIdx.y;
  t.live = ALL_ROWS;
  t.split = src.split;
  t.nwg = src.nwg;
  t.rank = src.split > 1 ? (int)sm90::cluster_rank() : 0;
  if (src.table) {
    const int* row = src.table + (int64_t)tile * 8;
    t.orow = row[4]; t.ocol = row[5];
    t.r0 = row[0]; t.r1 = row[2]; t.c0 = row[1]; t.c1 = row[3];
    return src.blocks[3 * row[6]];
  }
  const int bm = shape_bm(src.shape), bn = shape_bn(src.shape);
  const int band = tile / (RASTER_ROWS * src.tiles_c);
  const int rows = min(RASTER_ROWS, src.tiles_r - band * RASTER_ROWS);
  const int rem = tile - band * RASTER_ROWS * src.tiles_c;
  t.orow = src.row0 + (band * RASTER_ROWS + rem % rows) * bm;
  t.ocol = src.col0 + (rem / rows) * bn;
  t.r0 = t.orow; t.r1 = min(t.orow + bm, src.row0 + src.rows);
  t.c0 = t.ocol; t.c1 = min(t.ocol + bn, src.col0 + src.cols);
  return src.shape;
}

template <typename R>
__global__ void __launch_bounds__(2 * WG_THREADS + PRODUCER_THREADS, 2)
gemm_bf16_kernel(const __grid_constant__ CUtensorMap ma16,
                 const __grid_constant__ CUtensorMap ma,
                 const __grid_constant__ CUtensorMap mb,
                 const __grid_constant__ GemmArgs g, const TileSrc src) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  Tile t;
  t.g = g;
  const int shape = resolve_tile(src, t);
  const uint32_t raw = sm90::smem_u32(smem_raw);
  t.smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  tile_by_shape<R>(shape, t, Maps{&ma16, &ma, &mb});
}

// The backward epilogue's kernel: gemm_bf16_kernel's block with the
// cotangent dy, over route R's GRAD tiles.
struct GradArgs {
  const void* dy;
  int dy_dtype;
};

template <typename R>
__global__ void __launch_bounds__(2 * WG_THREADS + PRODUCER_THREADS, 2)
gemm_bf16_bwd_kernel(const __grid_constant__ CUtensorMap ma16,
                     const __grid_constant__ CUtensorMap ma,
                     const __grid_constant__ CUtensorMap mb,
                     const __grid_constant__ GemmArgs g, const TileSrc src,
                     const GradArgs d) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  Tile t;
  t.g = g;
  t.dy = d.dy;
  t.dy_dtype = d.dy_dtype;
  const int shape = resolve_tile(src, t);
  const uint32_t raw = sm90::smem_u32(smem_raw);
  t.smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  tile_by_shape<ActGrad<R>>(shape, t, Maps{&ma16, &ma, &mb});
}

template <typename R>
__global__ void __launch_bounds__(NT)
gemm_f32_kernel(const __grid_constant__ GemmArgs g, const TileSrc src) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  Tile t;
  t.g = g;
  t.smem = smem;
  const int shape = resolve_tile(src, t);
  tile_by_shape<R>(shape, t, Maps{nullptr, nullptr, nullptr});
}

// ---------------------------------------------------------------------------
// Host side: launch configuration.
// ---------------------------------------------------------------------------

// Consumer warpgroups of a launch: two when a tile of bm 128 is in it
// (or on route C, which always runs two), else one.
int consumer_wgs(int route, int max_bm) {
  return route == ROUTE_C || max_bm > 64 ? 2 : 1;
}

// GRAD: the backward epilogue's kernel, with its cotangent `d`.
template <typename R, bool GRAD = false>
cudaError_t launch_bf16(const GemmArgs& g, const TileSrc& src, int tiles,
                        int nb, cudaStream_t s, const GradArgs& d = {}) {
  constexpr bool tma = std::is_same<R, TmaRoute>::value;
  static bool configured = false;
  if (!configured) {
    const int bytes = tma ? ring_bytes(2) : LD_SMEM;
    cudaError_t e;
    if constexpr (GRAD)
      e = cudaFuncSetAttribute(gemm_bf16_bwd_kernel<R>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    else
      e = cudaFuncSetAttribute(gemm_bf16_kernel<R>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  CUtensorMap ma16{}, ma{}, mb{};
  if (tma) {
    // A (nb, m, k) and an "nt" B (nb, n, k): K-major boxes of BK x 16,
    // BK x ABOX and BK x 64; an "nn" B (nb, k, n): MN-major boxes of
    // 64 x BK.
    const CUtensorMapSwizzle kmajor =
        ROWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
    const bool ok =
        make_map(&ma16, g.a, g.k, g.m, nb, BK, 16, kmajor) &&
        make_map(&ma, g.a, g.k, g.m, nb, BK, ABOX, kmajor) &&
        (g.nt ? make_map(&mb, g.b, g.k, g.n, nb, BK, 64, kmajor)
              : make_map(&mb, g.b, g.n, g.k, nb, 64, BK,
                         CU_TENSOR_MAP_SWIZZLE_128B));
    if (!ok) return cudaErrorInvalidValue;
  } else if (src.split != 1) {
    return cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * src.split, nb, 1);
  cfg.blockDim = dim3(src.nwg * WG_THREADS + (tma ? PRODUCER_THREADS : 0));
  cfg.dynamicSmemBytes = tma ? ring_bytes(src.nwg) : LD_SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  if (src.split > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = src.split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  cudaError_t e;
  if constexpr (GRAD)
    e = cudaLaunchKernelEx(&cfg, gemm_bf16_bwd_kernel<R>, ma16, ma, mb, g,
                           src, d);
  else
    e = cudaLaunchKernelEx(&cfg, gemm_bf16_kernel<R>, ma16, ma, mb, g, src);
  return e != cudaSuccess ? e : cudaGetLastError();
}

cudaError_t launch(const GemmArgs& g, const TileSrc& src, int in_dtype,
                   int route, int tiles, int nb, cudaStream_t s) {
  if (tiles <= 0 || src.split < 1 || src.split > MAX_CLUSTER)
    return cudaErrorInvalidValue;
  if (in_dtype == DT_F32) {
    if (src.split != 1) return cudaErrorInvalidValue;
    gemm_f32_kernel<F32Route><<<dim3(tiles, nb), NT, 0, s>>>(g, src);
    return cudaGetLastError();
  }
  if (in_dtype != DT_BF16) return cudaErrorInvalidValue;
  if (route == ROUTE_C) return launch_bf16<LdRoute>(g, src, tiles, nb, s);
  if (route == ROUTE_A || route == ROUTE_B)
    return launch_bf16<TmaRoute>(g, src, tiles, nb, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// route: ROUTE_A / ROUTE_B (TMA ring) or ROUTE_C (loads through registers)
// for bf16, ignored for fp32; split: blocks a tile's K is split over (a
// cluster, 1 for none); max_bm: the largest template bm in the table.
extern "C" int gemm_fused(const void* a, const void* b, const void* bias,
                          const void* c, void* out, const int* table,
                          const int* blocks, int num_tiles, int nb, int m,
                          int n, int k, int nt, int in_dtype, int bias_dtype,
                          int c_dtype, int out_dtype, int epi, int route,
                          int split, int max_bm, void* stream) {
  GemmArgs g{a, b, bias, c, out, m, n, k, nt, bias_dtype, c_dtype, out_dtype,
             epi};
  TileSrc src{table, blocks, 0, 0, 0, 0, 0, 1, 1, split,
              consumer_wgs(route, max_bm)};
  return launch(g, src, in_dtype, route, num_tiles, nb,
                static_cast<cudaStream_t>(stream));
}

// The backward epilogue over gemm_fused's tile table (bf16 operands only):
// out = dy * act'(C? + A @ op(B) (+ bias)) for an activation epilogue `epi`.
extern "C" int gemm_act_bwd(const void* a, const void* b, const void* bias,
                            const void* c, const void* dy, void* out,
                            const int* table, const int* blocks,
                            int num_tiles, int nb, int m, int n, int k,
                            int nt, int bias_dtype, int c_dtype,
                            int dy_dtype, int out_dtype, int epi, int route,
                            int split, int max_bm, void* stream) {
  if (epi < EPI_GELU || epi > EPI_BIAS_SILU || num_tiles <= 0 || split < 1 ||
      split > MAX_CLUSTER)
    return cudaErrorInvalidValue;
  GemmArgs g{a, b, bias, c, out, m, n, k, nt, bias_dtype, c_dtype, out_dtype,
             epi};
  TileSrc src{table, blocks, 0, 0, 0, 0, 0, 1, 1, split,
              consumer_wgs(route, max_bm)};
  const GradArgs d{dy, dy_dtype};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == ROUTE_C)
    return launch_bf16<LdRoute, true>(g, src, num_tiles, nb, s, d);
  if (route == ROUTE_A || route == ROUTE_B)
    return launch_bf16<TmaRoute, true>(g, src, num_tiles, nb, s, d);
  return cudaErrorInvalidValue;
}

extern "C" int gemm_region(const void* a, const void* b, const void* bias,
                           const void* c, void* out, int row0, int col0,
                           int rows, int cols, int bm, int bn, int nb, int m,
                           int n, int k, int nt, int in_dtype, int bias_dtype,
                           int c_dtype, int out_dtype, int epi, int route,
                           int split, void* stream) {
  GemmArgs g{a, b, bias, c, out, m, n, k, nt, bias_dtype, c_dtype, out_dtype,
             epi};
  for (int shape = 0; shape < 6; ++shape) {
    if (shape_bm(shape) != bm || shape_bn(shape) != bn) continue;
    const int tiles_r = (rows + bm - 1) / bm, tiles_c = (cols + bn - 1) / bn;
    TileSrc src{nullptr, nullptr, shape, row0, col0, rows, cols, tiles_r,
                tiles_c, split, consumer_wgs(route, bm)};
    return launch(g, src, in_dtype, route, tiles_r * tiles_c, nb,
                  static_cast<cudaStream_t>(stream));
  }
  return cudaErrorInvalidValue;
}
