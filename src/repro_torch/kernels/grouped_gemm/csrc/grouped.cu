// Ragged grouped GEMM (MoE expert compute) for Hopper (sm_90a).
//
// Replaces the reference package's three TPU kernels
// (src/repro/kernels/grouped_gemm/kernel.py):
//   * grouped_fused  <- build_fused_grouped_kernel (_fused_grouped_kernel):
//     one launch over the runtime tile table (row0, row_end, row_start,
//     expert, state); one thread block per (table row, N block).  Rows are
//     addressed from row0, so the reference's clamped row_start window is
//     not needed;
//   * grouped_padded <- build_grouped_gemm_kernel (_grouped_kernel): the
//     pad/scatter lowering.  Grid (T_pad / bm, N / bn); a block reads its
//     expert from block_expert and, at or past nrows[0] (read in the
//     kernel), skips the product and stores the epilogue of a zero
//     accumulator, as the TPU kernel does;
//   * grouped_bwd    <- build_fused_grouped_bwd_kernel
//     (_fused_grouped_bwd_kernel): dX = dY W^T, dW = X^T dY and db in one
//     deterministic launch with no atomics.  The TPU kernel adds into dW by
//     read-modify-write along a sequential grid; here the blocks split into
//     two roles by blockIdx: dX blocks, one per (table row, K block), each
//     reducing over N for its owned rows (zeros for ZERO rows); dW blocks,
//     one per (expert, K block, N block), each reducing over that expert's
//     rows [off[e], off[e+1]) and, at K block 0, summing db.  An expert
//     with no rows writes zero dW and db.  The dX blocks come first, so
//     their long reductions start before the short dW tiles.
//
// What bounds it on the H100 at the main-path shapes (phi3.5-moe-42b,
// d 4096, 16 experts of d_ff 6400, top-2): a prefill or training step
// sends 4096 capacity rows through each expert GEMM, 2 x 4096 x 4096 x 6400
// = 215 GFLOP against 86 MB of weights and 86 MB of activations, far above
// the ~295 flop/byte ridge: the bf16 tensor cores bound the forward, and
// with 128 x 128 tiles the L2's rate of feeding each SM its K panels.
// Decode sends 512 rows, 32 an expert: the 839 MB of expert weights per
// GEMM bound it on HBM, and the 32 owned rows of a bm-128 tile are a
// quarter of its rows.  The backward's dY is fp32, but an fp32 dY times a
// bf16 x or w is exactly two bf16 products, of hi = bf16(dY) and of lo =
// bf16(dY - hi) (2^-16 relative left out), so its two products are four
// bf16 ones: 859 GFLOP, 0.87 ms at 989 TFLOP/s, against 2.7 GB (0.81 ms
// at 3.35 TB/s), of which dW's fp32 stores are 1.68 GB.  On route A the
// L2 binds first: a 128 x 128 tile reads 24 KB from L2 for each 32-deep
// stage of 2.1 MFLOP (16 KB of it dY's fp32), about 10 GB a main-path
// call, twice what the SMs can draw from L2 in 0.87 ms.
//
// The backward's routes, chosen per call in kernel.py (choose_bwd_route),
// which counts them:
//   (A) bf16 x and w and an fp32 dY that TMA can read (16-byte aligned
//       bases, K and N multiples of 8): grouped_bwd_wgmma.  Thread 0 keeps
//       a ring of BWD_STAGES stages in flight by TMA, refilling a stage a
//       panel after both warpgroups release it; the two warpgroups run
//       every product on wgmma m64n128k16, dY's fp32 values split into hi
//       and lo register A fragments on their way out of shared memory
//       (both pieces into the same fp32 accumulator; bf16 operands go in
//       exactly, never TF32), a k-step's fragments made while the previous
//       k-step's products run.  A stage is BWD_PANEL deep:
//         dX tile (a table row's <= 128 rows x BWD_TILE columns of K): A =
//           dY's rows (an fp32 box of 64 rows a warpgroup, 128-byte
//           swizzle), B = W[e] read K-major (a box of 32 n x 128 kc of
//           the expert's own K extent, 64-byte swizzle), over all of N.
//           Warpgroups whose 64 rows hold no owned row issue nothing;
//           rows the tile loads but does not own (the next expert's, rows
//           past the sum) reach only accumulator rows never stored.  The
//           fp32 rows leave the registers by 8-byte stores, whole 32-byte
//           sectors a warp.
//         dW tile (an expert's BWD_TILE kr x BWD_TILE nc): dW^T is
//           computed, A = dY^T (four fp32 boxes of 32 nc x 32 rows, read
//           transposed without bank conflicts), B = x read MN-major (two
//           boxes of 64 kr x 32 rows, 128-byte swizzle), over the expert's
//           rows only.  A panel that runs past off[e+1] (into the next
//           expert's rows, or past the sum, where x and dY may hold NaN)
//           zeroes both operands' rows there with `where`, never by a
//           product (0 x NaN is NaN): dY's in registers, x's in shared
//           memory before the fence.proxy.async that hands it to wgmma.
//           db is summed from the same masked registers at K block 0.
//           dW^T leaves the registers by 4-byte stores, four whole
//           32-byte sectors a warp.
//       Two blocks an SM (99 KB of shared memory and 128 registers a
//       thread each): one block's loads, stores and tile changes overlap
//       the other's products.  dX blocks take their tiles in bands of
//       RASTER_ROWS row tiles, a band column by column, as the forward
//       does, so an expert's W panel is read from HBM about once.
//       Measured against this: the dX tiles run near the L2's rate; the
//       short dW tiles (eight stages at 256 rows an expert) take about
//       twice as long for the same bytes and products.  Tried and slower
//       on the H100: a producer warp (96 registers, spills), dW tiles
//       streamed several to a block through one ring, reductions started
//       at staggered panels, and a persistent block an SM with a
//       producer warp and the next panel's fragments made during the
//       current panel's products (ptxas then serializes the wgmmas).
//   (C) bf16 operands TMA cannot read (e.g. N = 300) and (fp32) fp32 x and
//       w: grouped_bwd_kernel, register-blocked CUDA-core fp32 FMAs
//       (tile_f32, never TF32): dX blocks of a table row's rows x 64
//       columns of K, dW blocks of 64 x 64, db by one thread a column.
//
// The bf16 forward (both entry points) runs the wgmma tile of
// ../../gemm/csrc/wgmma_tile.cuh, on one of two routes chosen per call in
// kernel.py (choose_route), which counts them:
//   (A) operands TMA can read: a ring of STAGES 32-deep K panels (two
//       blocks an SM) filled by TMA from an A map over x (rows, K) at the
//       tile's first row and a 3-D B map over w (E, K, N) at the tile's
//       expert, MN-major in the 128-byte swizzle.  Each expert's K extent
//       is its own, so TMA's zero fill masks the K tail and the N tail and
//       no panel bleeds into expert e + 1.  One producer warp, one
//       consumer warpgroup per 64 rows of bm running wgmma m64nBNk16 with
//       fp32 accumulators in registers.  Tiles are row-aware: the producer
//       loads only the 64-row A boxes that hold owned rows (and expects
//       their bytes), and a consumer warpgroup with none issues no
//       products, so a 32-row decode group on a bm-128 tile costs one box
//       and one warpgroup's products.  bm 16 tiles run swap-AB (the weight
//       columns are wgmma's 64 rows, the <= 16 x rows its N).
//   (C) bf16 operands TMA cannot take (a base not 16-byte aligned, or a row
//       not a multiple of 16 bytes, e.g. N = 300): all threads load the
//       next panel through registers, zero-filled past K, N and the last
//       row, into the same swizzled layouts, feeding the same wgmma and
//       epilogue code.
// Both stage the finished fp32 tile in shared memory, load the expert's
// bias row once a tile, and store rows of eight owned columns with 16-byte
// stores.  Blocks take the tiles in bands of RASTER_ROWS row tiles, a band
// column by column, so the row tiles of one expert and one column block
// run together (a prefill weight panel is read from HBM about once) and a
// band's x rows stay in L2 while the panels stream past.  The fp32
// forward keeps register-blocked CUDA-core FMAs (tile_f32; never TF32).
//
// Rows: COMPUTE tiles store only [row0, row_end); ZERO tiles store zeros;
// SKIP tiles store nothing; a padded block at or past nrows[0] stores the
// epilogue of a zero accumulator, so every output element has one storing
// block.  A tile may load x rows it does not own where they lie inside x
// (the next expert's rows, rows past sum(group_sizes), which may hold
// NaN): each accumulator row depends on its own x row alone, and such rows
// are never stored.  K and N tails are zero.  Past x's last row TMA fills
// zeros.
//
// The epilogue runs on the fp32 accumulator: + the expert's bias row, then
// the activation (gelu is the tanh approximation), then the cast to x's
// type.  Every entry point is one kernel launch.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

#include "../../gemm/csrc/wgmma_tile.cuh"
#include "../../ssd_chunk/csrc/ssd_sm90.cuh"

namespace {

constexpr int NT = 128;  // threads per block of the fp32 kernels
constexpr int BK = 32;   // K (reduction) panel (H100_SXM.grouped_blocks)
constexpr int SMEM_BYTES = 2 * BK * (128 + 4) * 4;  // largest tile, fp32
constexpr int BWD_TK = 64;  // backward: a dX tile's K width, a dW tile's K rows
constexpr int BWD_TN = 64;  // backward: a dW tile's N columns
static_assert(BK == wgt::BK, "the fp32 and wgmma tiles share the K panel");
// The backward's route A (grouped_bwd_wgmma; kernel.py's BWD_TILE,
// BWD_PANEL, BWD_STAGES): a ring stage holds an fp32 dY slot of BWD_TILE
// rows (dX) or columns (dW) x BWD_PANEL and a bf16 slot of w (dX) or x
// (dW) of the same extent, each on a 1024-byte boundary, with 1024 bytes of
// alignment slack in front and two mbarriers a stage behind.  Two blocks
// of two warpgroups fit an SM: 16 warps, four a scheduler, 128 registers a
// thread (a producer warp more would leave five warps on one scheduler and
// 96 registers, too few for the accumulator and the split fragments).
constexpr int BWD_TILE = 128;  // a dX tile's K columns; a dW tile's K x N
constexpr int BWD_PANEL = 32;  // a stage's depth: N (dX) or rows (dW)
constexpr int BWD_STAGES = 4;
constexpr int BWD_WGS = 2;     // warpgroups
constexpr int BWD_THREADS = BWD_WGS * wgt::WG_THREADS;
constexpr int BWD_A_SLOT = BWD_TILE * BWD_PANEL * 4;
constexpr int BWD_B_SLOT = BWD_TILE * BWD_PANEL * 2;
constexpr int BWD_STAGE = BWD_A_SLOT + BWD_B_SLOT;
constexpr int BWD_SMEM = 1024 + BWD_STAGES * BWD_STAGE + 2 * BWD_STAGES * 8;
// The bf16 forward takes its tiles in bands of RASTER_ROWS row tiles, a
// band column by column (block_tile): four is two experts' 128-row tiles
// at phi3.5-moe's prefill, where it was faster than the row-fastest order
// and than bands of 8-32 on the H100.
constexpr int RASTER_ROWS = 4;

enum { EPI_NONE = 0, EPI_BIAS, EPI_GELU, EPI_SILU, EPI_RELU, EPI_BIAS_GELU,
       EPI_BIAS_SILU };
enum { DT_F32 = 0, DT_BF16 = 1 };
enum { TILE_SKIP = 0, TILE_COMPUTE = 1, TILE_ZERO = 2 };
enum { ROUTE_A = 0, ROUTE_C = 2, ROUTE_F32 = 3 };

struct FwdArgs {
  const void* x;     // (T, K) fused, (T_pad, K) padded
  const void* w;     // (E, K, N)
  const void* bias;  // (E, N) or null
  void* out;         // like x's rows, (., N), in x's type
  int k, n;
  int bias_dtype;
  int epi;
};

struct BwdArgs {
  const void* x;     // (T, K)
  const float* dy;   // (T, N) pre-activation cotangent
  const void* w;     // (E, K, N)
  const int* table;  // (max_tiles, 5)
  const int* off;    // (E + 1,) row offsets of the experts
  float* dx;         // (T, K)
  float* dw;         // (E, K, N)
  float* db;         // (E, N) or null
  int t, k, n;
};

template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ void store_as(void* p, int64_t i, float v) {
  if constexpr (std::is_same<T, float>::value)
    reinterpret_cast<float*>(p)[i] = v;
  else
    reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
}

__device__ __forceinline__ float load_f(const void* p, int dtype, int64_t i) {
  return dtype == DT_BF16
             ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
             : reinterpret_cast<const float*>(p)[i];
}

// Bias of expert e (its row of the (E, N) table), then the activation.
__device__ __forceinline__ float epilogue(float v, const FwdArgs& g, int e,
                                          int col) {
  const int ep = g.epi;
  if (ep == EPI_BIAS || ep == EPI_BIAS_GELU || ep == EPI_BIAS_SILU)
    v += load_f(g.bias, g.bias_dtype, (int64_t)e * g.n + col);
  if (ep == EPI_GELU || ep == EPI_BIAS_GELU) {
    const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
    v = 0.5f * v * (1.f + tanhf(k0 * (v + 0.044715f * v * v * v)));
  } else if (ep == EPI_SILU || ep == EPI_BIAS_SILU) {
    v = v / (1.f + expf(-v));
  } else if (ep == EPI_RELU) {
    v = fmaxf(v, 0.f);
  }
  return v;
}

// C[BM x BN] = sum_k A(r, k) B(k, c) in fp32 FMAs over a reduction of
// length kdim, A and B read through loaders la(r, k) / lb(k, c) that mask
// their own row / column edges (the tile masks the reduction edge).
// A_ROW_FAST / B_K_FAST choose which index neighbouring threads walk when
// a panel is staged, so that they read neighbouring addresses.
// st(r, c, v) receives every element of the tile.
template <int BM, int BN, bool A_ROW_FAST, bool B_K_FAST, class LA, class LB,
          class ST>
__device__ __forceinline__ void tile_f32(int kdim, LA la, LB lb, ST st,
                                         unsigned char* smem) {
  constexpr int LDSA = BM + 4, LDSB = BN + 4;
  constexpr int TM = BM / 8, TN = BN / 16;
  float* As = reinterpret_cast<float*>(smem);  // BK x LDSA (A transposed)
  float* Bs = As + BK * LDSA;                  // BK x LDSB
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < kdim; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = A_ROW_FAST ? i % BM : i / BK;
      const int kk = A_ROW_FAST ? i / BM : i % BK;
      As[kk * LDSA + r] = (k0 + kk < kdim) ? la(r, k0 + kk) : 0.f;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int kk = B_K_FAST ? i % BK : i / BN;
      const int c = B_K_FAST ? i / BK : i % BN;
      Bs[kk * LDSB + c] = (k0 + kk < kdim) ? lb(k0 + kk, c) : 0.f;
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
    for (int j = 0; j < TN; ++j) st(ty + i * 8, tx + j * 16, acc[i][j]);
}

// One fp32 forward tile: rows [row0, row0 + nvalid) of x times expert e's
// panel, columns [col0, col0 + BN), epilogue, store of the valid rows and
// columns.
template <typename T, int BM, int BN>
__device__ __noinline__ void fwd_tile(const FwdArgs g, int row0, int nvalid,
                                      int e, int col0, unsigned char* smem) {
  static_assert(std::is_same<T, float>::value, "bf16 takes the wgmma tile");
  const T* x = reinterpret_cast<const T*>(g.x) + (int64_t)row0 * g.k;
  const T* w = reinterpret_cast<const T*>(g.w) + (int64_t)e * g.k * g.n;
  const int k = g.k, n = g.n;
  auto la = [=](int r, int kk) {
    return r < nvalid ? x[(int64_t)r * k + kk] : zero_of<T>();
  };
  auto lb = [=](int kk, int c) {
    return col0 + c < n ? w[(int64_t)kk * n + col0 + c] : zero_of<T>();
  };
  auto st = [=](int r, int c, float v) {
    if (r < nvalid && col0 + c < n)
      store_as<T>(g.out, (int64_t)(row0 + r) * n + col0 + c,
                  epilogue(v, g, e, col0 + c));
  };
  tile_f32<BM, BN, false, false>(k, la, lb, st, smem);
}

// The (bm, bn) shapes, as kernel.py's SHAPES lists them (bk is BK).
__host__ __device__ inline int shape_bm(int shape) {
  return shape < 2 ? 16 : shape < 4 ? 64 : 128;
}
__host__ __device__ inline int shape_bn(int shape) {
  return shape % 2 ? 128 : 64;
}

template <typename T>
__device__ __forceinline__ void fwd_by_shape(int shape, const FwdArgs& g,
                                             int row0, int nvalid, int e,
                                             int col0, unsigned char* smem) {
  switch (shape) {
    case 0: fwd_tile<T, 16, 64>(g, row0, nvalid, e, col0, smem); break;
    case 1: fwd_tile<T, 16, 128>(g, row0, nvalid, e, col0, smem); break;
    case 2: fwd_tile<T, 64, 64>(g, row0, nvalid, e, col0, smem); break;
    case 3: fwd_tile<T, 64, 128>(g, row0, nvalid, e, col0, smem); break;
    case 4: fwd_tile<T, 128, 64>(g, row0, nvalid, e, col0, smem); break;
    case 5: fwd_tile<T, 128, 128>(g, row0, nvalid, e, col0, smem); break;
    default: break;
  }
}

// Rows [row0, row0 + nvalid) x columns [col0, col0 + bn) without a
// product: zeros (a ZERO tile) or the epilogue of a zero accumulator (a
// padded block past nrows).
template <typename T>
__device__ void fwd_fill(const FwdArgs& g, int row0, int nvalid, int e,
                         int col0, int bn, bool epilogue_of_zero) {
  for (int i = threadIdx.x; i < nvalid * bn; i += NT) {
    const int c = col0 + i % bn;
    if (c < g.n)
      store_as<T>(g.out, (int64_t)(row0 + i / bn) * g.n + c,
                  epilogue_of_zero ? epilogue(0.f, g, e, c) : 0.f);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
grouped_fused_kernel(FwdArgs g, const int* __restrict__ table, int shape) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  const int* row = table + (int64_t)blockIdx.x * 5;
  const int state = row[4];
  if (state == TILE_SKIP) return;
  const int bn = shape_bn(shape), col0 = blockIdx.y * bn;
  const int row0 = row[0], nvalid = row[1] - row[0], e = row[3];
  if (state == TILE_ZERO)
    fwd_fill<T>(g, row0, nvalid, e, col0, bn, false);
  else
    fwd_by_shape<T>(shape, g, row0, nvalid, e, col0, smem);
}

template <typename T>
__global__ void __launch_bounds__(NT)
grouped_padded_kernel(FwdArgs g, const int* __restrict__ block_expert,
                      const int* __restrict__ nrows, int shape) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  const int bm = shape_bm(shape), bn = shape_bn(shape);
  const int row0 = blockIdx.x * bm, col0 = blockIdx.y * bn;
  const int e = block_expert[blockIdx.x];
  if (row0 < nrows[0])
    fwd_by_shape<T>(shape, g, row0, bm, e, col0, smem);
  else
    fwd_fill<T>(g, row0, bm, e, col0, bn, true);
}

// ---------------------------------------------------------------------------
// bf16: the wgmma tile (wgmma_tile.cuh), routes A and C.
// ---------------------------------------------------------------------------

// Where a block's tile comes from: a row of the fused table, or a row
// block of the padded layout.  `nwg`: consumer warpgroups of the launch.
struct GroupSrc {
  const int* table;         // fused: (max_tiles, 5) rows; null: padded
  const int* block_expert;  // padded: (T_pad / bm,)
  const int* nrows;         // padded: (1,)
  int shape, nwg;
  int tiles;                // row tiles (table rows or row blocks)
};

// The block's (row tile, column block).  Blocks start in launch order (x
// fastest); they take the tiles in bands of RASTER_ROWS row tiles, a band
// column by column, so the row tiles of one expert and one column block
// run together (its weight panel is read from HBM about once) and a
// band's x rows stay in L2 while the weight panels stream past.
__device__ __forceinline__ void block_tile(const GroupSrc& src, int& tile,
                                           int& cb) {
  const int ncols = gridDim.y;
  const int lin = blockIdx.y * gridDim.x + blockIdx.x;
  const int b = lin / (RASTER_ROWS * ncols);
  const int rows = min(RASTER_ROWS, src.tiles - b * RASTER_ROWS);
  const int rem = lin - b * RASTER_ROWS * ncols;
  tile = b * RASTER_ROWS + rem % rows;
  cb = rem / rows;
}

// Rows [row0, row_end) x columns [col0, col0 + bn) without a product, in
// rows of eight columns: zeros (a ZERO tile) or the epilogue of a zero
// accumulator with expert e's bias row (a padded block past nrows).
__device__ void fill_rows(const wgt::GemmArgs& g, int row0, int row_end,
                          int col0, int bn, int e, bool epilogue_of_zero) {
  const int chunks = bn / 8;
  for (int q = threadIdx.x; q < (row_end - row0) * chunks; q += blockDim.x) {
    const int r = row0 + q / chunks, c = col0 + q % chunks * 8;
    if (c >= g.n) continue;
    const int hi = min(g.n - c, 8);
    float v[8] = {};
    if (epilogue_of_zero) {
      if (wgt::has_bias(g.epi))
        wgt::load8(g.bias, g.bias_dtype, (int64_t)e * g.n + c, hi, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = wgt::activate(v[i], g.epi);
    }
    wgt::store8(g.out, g.out_dtype, (int64_t)r * g.n + c, 0, hi, v);
  }
}

// The (route, shape) tile routines, in kernel.py's SHAPES order: six
// shapes on each of the two routes, shared by both entry points.
template <typename R>
__device__ __forceinline__ void wgmma_by_shape(int shape, const wgt::Tile& t,
                                               const wgt::Maps& m) {
  switch (shape) {
    case 0: R::template run<16, 64>(t, m); break;
    case 1: R::template run<16, 128>(t, m); break;
    case 2: R::template run<64, 64>(t, m); break;
    case 3: R::template run<64, 128>(t, m); break;
    case 4: R::template run<128, 64>(t, m); break;
    case 5: R::template run<128, 128>(t, m); break;
    default: break;
  }
}

// One block: its tile from the table row (fused) or row block (padded),
// x's rows as A (batch 0), the expert's panel as B (the B map's batch),
// the expert's bias row.
template <typename R>
__global__ void __launch_bounds__(2 * wgt::WG_THREADS + wgt::PRODUCER_THREADS,
                                  2)
grouped_wgmma_kernel(const __grid_constant__ CUtensorMap ma16,
                     const __grid_constant__ CUtensorMap ma,
                     const __grid_constant__ CUtensorMap mb,
                     const __grid_constant__ wgt::GemmArgs g,
                     const GroupSrc src) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int bm = shape_bm(src.shape), bn = shape_bn(src.shape);
  int tile, cb;
  block_tile(src, tile, cb);
  const int col0 = cb * bn;
  int row0, row_end, e;
  if (src.table) {
    const int* row = src.table + (int64_t)tile * 5;
    const int state = row[4];
    if (state == TILE_SKIP) return;
    row0 = row[0];
    row_end = row[1];
    e = row[3];
    if (state == TILE_ZERO) {
      fill_rows(g, row0, row_end, col0, bn, e, false);
      return;
    }
  } else {
    row0 = tile * bm;
    row_end = row0 + bm;
    e = src.block_expert[tile];
    if (row0 >= src.nrows[0]) {
      fill_rows(g, row0, row_end, col0, bn, e, true);
      return;
    }
  }
  wgt::Tile t;
  t.g = g;
  if (wgt::has_bias(g.epi))
    t.g.bias = static_cast<const char*>(g.bias) +
               (int64_t)e * g.n * (g.bias_dtype == wgt::DT_BF16 ? 2 : 4);
  t.batch = 0;
  t.bbatch = e;
  t.orow = t.r0 = row0;
  t.r1 = row_end;
  t.live = row_end - row0;
  t.ocol = t.c0 = col0;
  t.c1 = min(col0 + bn, g.n);
  t.rank = 0;
  t.split = 1;
  t.nwg = src.nwg;
  const uint32_t raw = sm90::smem_u32(smem_raw);
  t.smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  wgmma_by_shape<R>(src.shape, t, wgt::Maps{&ma16, &ma, &mb});
}

// dX[r, kc] = sum_n dY[r, n] W[e][kc, n] over the owned rows.
template <typename T, int BM>
__device__ __noinline__ void dx_tile(const BwdArgs g, int row0, int nvalid,
                                     int e, int kc0, unsigned char* smem) {
  const float* dy = g.dy + (int64_t)row0 * g.n;
  const T* w = reinterpret_cast<const T*>(g.w) + (int64_t)e * g.k * g.n;
  const int k = g.k, n = g.n;
  float* dx = g.dx;
  auto la = [=](int r, int nn) {
    return r < nvalid ? dy[(int64_t)r * n + nn] : 0.f;
  };
  auto lb = [=](int nn, int c) {
    return kc0 + c < k ? to_f(w[(int64_t)(kc0 + c) * n + nn]) : 0.f;
  };
  auto st = [=](int r, int c, float v) {
    if (r < nvalid && kc0 + c < k)
      dx[(int64_t)(row0 + r) * k + kc0 + c] = v;
  };
  tile_f32<BM, BWD_TK, false, true>(n, la, lb, st, smem);
}

// dW[e][kr, nc] = sum_r X[r, kr] dY[r, nc] over expert e's rows, and at K
// block 0 db[e, nc] = sum_r dY[r, nc].  No rows: zeros.
template <typename T>
__device__ __noinline__ void dw_tile(const BwdArgs g, int e, int kr0, int nc0,
                                     unsigned char* smem) {
  const int r0 = g.off[e], rows = g.off[e + 1] - r0;
  const T* x = reinterpret_cast<const T*>(g.x) + (int64_t)r0 * g.k;
  const float* dy = g.dy + (int64_t)r0 * g.n;
  const int k = g.k, n = g.n;
  float* dw = g.dw + (int64_t)e * k * n;
  auto la = [=](int i, int rr) {
    return kr0 + i < k ? to_f(x[(int64_t)rr * k + kr0 + i]) : 0.f;
  };
  auto lb = [=](int rr, int c) {
    return nc0 + c < n ? dy[(int64_t)rr * n + nc0 + c] : 0.f;
  };
  auto st = [=](int i, int c, float v) {
    if (kr0 + i < k && nc0 + c < n) dw[(int64_t)(kr0 + i) * n + nc0 + c] = v;
  };
  tile_f32<BWD_TK, BWD_TN, true, false>(rows, la, lb, st, smem);
  if (g.db != nullptr && kr0 == 0) {
    for (int c = threadIdx.x; c < BWD_TN; c += NT) {
      if (nc0 + c >= n) continue;
      float s = 0.f;
      for (int r = 0; r < rows; ++r) s += dy[(int64_t)r * n + nc0 + c];
      g.db[(int64_t)e * n + nc0 + c] = s;
    }
  }
}

template <typename T, int BM>
__global__ void __launch_bounds__(NT)
grouped_bwd_kernel(BwdArgs g, int n_dx) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  const int kb = (g.k + BWD_TK - 1) / BWD_TK;
  int b = blockIdx.x;
  if (b < n_dx) {
    const int* row = g.table + (int64_t)(b / kb) * 5;
    const int kc0 = (b % kb) * BWD_TK, state = row[4];
    const int row0 = row[0], nvalid = row[1] - row[0];
    if (state == TILE_COMPUTE) {
      dx_tile<T, BM>(g, row0, nvalid, row[3], kc0, smem);
    } else if (state == TILE_ZERO) {
      for (int i = threadIdx.x; i < nvalid * BWD_TK; i += NT) {
        const int kc = kc0 + i % BWD_TK;
        if (kc < g.k) g.dx[(int64_t)(row0 + i / BWD_TK) * g.k + kc] = 0.f;
      }
    }
    return;
  }
  b -= n_dx;
  const int nb = (g.n + BWD_TN - 1) / BWD_TN;
  const int e = b / (kb * nb), rem = b % (kb * nb);
  dw_tile<T>(g, e, (rem / nb) * BWD_TK, (rem % nb) * BWD_TN, smem);
}

// ---------------------------------------------------------------------------
// The backward's route A: TMA ring, wgmma, dY split into bf16 hi + lo.
// ---------------------------------------------------------------------------

// The byte offset of fp32 element (r, c) in a box of 128-byte rows (32
// columns) in the 128-byte swizzle, the box on a 1024-byte boundary.
__device__ __forceinline__ int swz128_f32(int r, int c) {
  return r * 128 + ((((c >> 2) ^ r) & 7) << 4) + (c & 3) * 4;
}

// Zeros in rows [row0, row0 + rows) x columns [c0, c0 + width) of an fp32
// matrix of row length ld (ld, c0 and width multiples of 4); columns past
// ld are not stored.
__device__ void zero_rows(float* p, int64_t row0, int rows, int ld, int c0,
                          int width) {
  const int chunks = width / 4;
  for (int q = threadIdx.x; q < rows * chunks; q += blockDim.x) {
    const int c = c0 + q % chunks * 4;
    if (c < ld)
      *reinterpret_cast<float4*>(p + (row0 + q / chunks) * ld + c) =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Keeps the compiler from reusing fragment registers an asynchronous
// wgmma may still read (place after the wait).
__device__ __forceinline__ void fence_frags(uint32_t (&a)[2][4]) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int m = 0; m < 4; ++m) asm volatile("" : "+r"(a[ks][m])::"memory");
}

// The maps of one backward call: dY (T, N) fp32 in boxes of 32 n x 64
// rows (dX's A) and 32 n x 32 rows (dW's A); w (E, K, N) in boxes of 32 n
// x 128 k (dX's B, K-major, 64-byte swizzle); x (T, K) in boxes of 64 k x
// 32 rows (dW's B, MN-major, 128-byte swizzle).
struct BwdMaps {
  const CUtensorMap* dyr;
  const CUtensorMap* dyc;
  const CUtensorMap* w;
  const CUtensorMap* x;
};

// One route-A tile.  DW = false: dX rows [row0, row0 + rows) (a table
// row's owned rows, of expert e) x K columns from k0, reduced over N.  DW
// = true: dW^T of expert e, N columns from n0 x K rows from k0, reduced
// over its rows [row0, row0 + rows).  `nact` warpgroups take part.
template <bool DW>
__device__ __forceinline__ void bwd_tile(const BwdArgs& g, const BwdMaps& m,
                                         unsigned char* smem, int e, int row0,
                                         int rows, int k0, int n0, int nact) {
  using namespace sm90;
  constexpr int S = BWD_STAGES;
  const int panels = ((DW ? rows : g.n) + BWD_PANEL - 1) / BWD_PANEL;
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + S * BWD_STAGE;  // full[s], then empty[s]
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (S + s), 4 * nact);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / wgt::WG_THREADS;
  if (wg >= nact) return;

  // Thread 0 fills the ring: panel p into stage p % S.  dW's boxes wholly
  // past N (dY) or K (x) are not loaded: their slot rows reach only
  // outputs that are never stored.
  const int ndy = DW ? min(4, (g.n - n0 + 31) / 32) : nact;
  const int nx = DW ? min(2, (g.k - k0 + 63) / 64) : 0;
  auto fill = [&](int p) {
    const int s = p % S;
    const uint32_t full = bars + 8 * s;
    const uint32_t a = base + s * BWD_STAGE, b = a + BWD_A_SLOT;
    if (DW) {
      const int r = row0 + p * BWD_PANEL;
      mbar_expect_tx(full, (ndy + nx) * 4096);
      for (int i = 0; i < ndy; ++i)
        tma_load_3d(a + i * 4096, m.dyc, full, n0 + 32 * i, r, 0);
      for (int h = 0; h < nx; ++h)
        tma_load_3d(b + h * 4096, m.x, full, k0 + 64 * h, r, 0);
    } else {
      mbar_expect_tx(full, nact * 64 * 128 + BWD_B_SLOT);
      for (int i = 0; i < nact; ++i)
        tma_load_3d(a + i * 64 * 128, m.dyr, full, p * BWD_PANEL,
                    row0 + 64 * i, 0);
      tma_load_3d(b, m.w, full, p * BWD_PANEL, k0, e);
    }
  };
  if (threadIdx.x == 0)
    for (int p = 0; p < min(S, panels); ++p) fill(p);

  // Warpgroup wg holds 64 rows of dX (dY's rows 64 wg ...) or of dW^T (N
  // columns n0 + 64 wg ...) x 128, in wgmma's accumulator layout: register
  // 4 j + 2 h + c holds row qr + 8 h, column 8 j + qc + c.
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int qr = 16 * warp + lane / 4, qc = 2 * (lane % 4);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float dbs[2] = {0.f, 0.f};  // dW: db of columns qr and qr + 8
  const bool want_db = DW && g.db != nullptr && k0 == 0;
  int s = 0;
  uint32_t phase = 0;
  for (int p = 0; p < panels; ++p) {
    mbar_wait(bars + 8 * s, phase);
    const unsigned char* as = smem + s * BWD_STAGE;
    const uint32_t b = base + s * BWD_STAGE + BWD_A_SLOT;
    int valid = BWD_PANEL;
    if constexpr (DW) {
      // Rows at or past the expert's end are zeroed in both operands: x's
      // in the slot (every thread a share, then the fence that hands them
      // to wgmma), dY's in registers.
      valid = rows - p * BWD_PANEL;
      if (valid < BWD_PANEL) {
        unsigned char* xs = smem + s * BWD_STAGE + BWD_A_SLOT;
        for (int i = threadIdx.x; i < (BWD_PANEL - valid) * 16;
             i += BWD_THREADS)
          *reinterpret_cast<uint4*>(xs + (i / 8 % 2) * 4096 +
                                    (valid + i / 16) * 128 + i % 8 * 16) =
              make_uint4(0u, 0u, 0u, 0u);
        fence_proxy_async();
        __syncthreads();
      }
    }
    // Each k-step's fragments are made while the previous k-step's
    // products run.
    uint32_t hi[2][4], lo[2][4];
    fence_regs(acc);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      if constexpr (DW) {
        // dY^T as A: element (row k, column mr) of box mr / 32.
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int mr = 64 * wg + qr + 8 * (i & 1);
          const int k = 16 * ks + qc + 8 * (i >> 1);
          const unsigned char* box = as + (mr >> 5) * 4096;
          float v0 = *reinterpret_cast<const float*>(
              box + swz128_f32(k, mr & 31));
          float v1 = *reinterpret_cast<const float*>(
              box + swz128_f32(k + 1, mr & 31));
          v0 = k < valid ? v0 : 0.f;
          v1 = k + 1 < valid ? v1 : 0.f;
          if (want_db) dbs[i & 1] += v0 + v1;
          ssd_sm90::split2(v0, v1, hi[ks][i], lo[ks][i]);
        }
      } else {
        // dY's rows as A: element (row, n) of the warpgroup's box.
        const unsigned char* box = as + wg * 64 * 128;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = qr + 8 * (i & 1), c = 16 * ks + qc + 8 * (i >> 1);
          const float2 v =
              *reinterpret_cast<const float2*>(box + swz128_f32(r, c));
          ssd_sm90::split2(v.x, v.y, hi[ks][i], lo[ks][i]);
        }
      }
      __syncwarp();  // wgmma is .aligned: the warp reconverges first
      wgmma_fence();
      // B: x's slot MN-major (dW), w's slot K-major (dX).
      const uint64_t desc = DW ? desc_mn128(b + ks * 2048)
                               : desc_k64(b + ks * 32);
      ssd_sm90::wgmma_rs<128, DW>(acc, hi[ks], desc);
      ssd_sm90::wgmma_rs<128, DW>(acc, lo[ks], desc);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_frags(hi);
    fence_frags(lo);
    if (lane == 0) mbar_arrive(bars + 8 * (S + s));
    // The previous panel's stage is refilled once every warp has released
    // it: a panel of slack, so thread 0 seldom waits for the other
    // warpgroup.
    if (threadIdx.x == 0 && p >= 1 && p - 1 + S < panels) {
      mbar_wait(bars + 8 * (S + (p - 1) % S), ((p - 1) / S) & 1);
      fill(p - 1 + S);
    }
    if (++s == S) { s = 0; phase ^= 1; }
  }

  if constexpr (DW) {
    if (want_db) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        dbs[h] += __shfl_xor_sync(0xffffffffu, dbs[h], 1);
        dbs[h] += __shfl_xor_sync(0xffffffffu, dbs[h], 2);
        const int c = n0 + 64 * wg + qr + 8 * h;
        if (lane % 4 == 0 && c < g.n) g.db[(int64_t)e * g.n + c] = dbs[h];
      }
    }
    // dW^T's registers straight to dW: a warp's store is four rows of
    // K x eight neighbouring columns of N, four whole 32-byte sectors.
    float* out = g.dw + ((int64_t)e * g.k + k0) * g.n + n0;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kr = 8 * j + qc + c;
        if (k0 + kr >= g.k) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int nc = 64 * wg + qr + 8 * h;
          if (n0 + nc < g.n)
            out[(int64_t)kr * g.n + nc] = acc[4 * j + 2 * h + c];
        }
      }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 64 * wg + qr + 8 * h, c = k0 + 8 * j + qc;
        if (r < rows && c < g.k)
          *reinterpret_cast<float2*>(g.dx + (int64_t)(row0 + r) * g.k +
                                     c) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
  }
}

// Blocks [0, n_dx) are dX tiles: a table row x BWD_TILE columns of K, in
// bands of RASTER_ROWS table rows, a band column by column.  The rest are
// dW tiles: (expert, K block, N block), N fastest.
__global__ void __launch_bounds__(BWD_THREADS, 2)
grouped_bwd_wgmma(const __grid_constant__ CUtensorMap m_dyr,
                  const __grid_constant__ CUtensorMap m_dyc,
                  const __grid_constant__ CUtensorMap m_w,
                  const __grid_constant__ CUtensorMap m_x,
                  const __grid_constant__ BwdArgs g, int tiles, int n_dx) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const BwdMaps m{&m_dyr, &m_dyc, &m_w, &m_x};
  const int kb = (g.k + BWD_TILE - 1) / BWD_TILE;
  if ((int)blockIdx.x < n_dx) {
    const int b = blockIdx.x;
    const int band = b / (RASTER_ROWS * kb);
    const int in_band = min(RASTER_ROWS, tiles - band * RASTER_ROWS);
    const int rem = b - band * RASTER_ROWS * kb;
    const int* row =
        g.table + (int64_t)(band * RASTER_ROWS + rem % in_band) * 5;
    const int state = row[4];
    const int row0 = row[0], rows = row[1] - row[0];
    const int k0 = rem / in_band * BWD_TILE;
    if (state == TILE_ZERO) zero_rows(g.dx, row0, rows, g.k, k0, BWD_TILE);
    if (state == TILE_COMPUTE)
      bwd_tile<false>(g, m, smem, row[3], row0, rows, k0, 0,
                      min(BWD_WGS, (rows + 63) / 64));
    return;
  }
  const int nb = (g.n + BWD_TILE - 1) / BWD_TILE;
  const int b = blockIdx.x - n_dx;
  const int e = b / (kb * nb), rem = b - e * kb * nb;
  const int k0 = rem / nb * BWD_TILE, n0 = rem % nb * BWD_TILE;
  const int row0 = g.off[e], rows = g.off[e + 1] - row0;
  if (rows > 0) {
    bwd_tile<true>(g, m, smem, e, row0, rows, k0, n0, BWD_WGS);
  } else {  // no rows: exact zeros
    zero_rows(g.dw + (int64_t)e * g.k * g.n, k0, min(BWD_TILE, g.k - k0),
              g.n, n0, BWD_TILE);
    if (g.db != nullptr && k0 == 0) zero_rows(g.db, e, 1, g.n, n0, BWD_TILE);
  }
}

int find_shape(int bm, int bn) {
  for (int shape = 0; shape < 6; ++shape)
    if (shape_bm(shape) == bm && shape_bn(shape) == bn) return shape;
  return -1;
}

template <int BM>
cudaError_t launch_bwd(const BwdArgs& g, int in_dtype, int n_dx, int n_dw,
                       cudaStream_t s) {
  const unsigned blocks = (unsigned)(n_dx + n_dw);
  if (in_dtype == DT_BF16)
    grouped_bwd_kernel<__nv_bfloat16, BM><<<blocks, NT, 0, s>>>(g, n_dx);
  else if (in_dtype == DT_F32)
    grouped_bwd_kernel<float, BM><<<blocks, NT, 0, s>>>(g, n_dx);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// A 3-D fp32 map over (inner, outer, 1) with a (box0, box1, 1) box in the
// 128-byte swizzle (box0 x 4 = 128 bytes).  TMA fills zeros past the
// extents.
bool make_map_f32(CUtensorMap* map, const float* ptr, uint64_t inner,
                  uint64_t outer, uint32_t box0, uint32_t box1) {
  wgt::EncodeTiled encode = wgt::encode_tiled();
  if (!encode || reinterpret_cast<uintptr_t>(ptr) % 16 || (inner * 4) % 16)
    return false;
  const cuuint64_t dims[3] = {inner, outer, 1};
  const cuuint64_t strides[2] = {inner * 4, inner * outer * 4};
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<float*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One launch of the backward's route A.  The shared-memory limit is raised
// once, so that a launch inside a CUDA-graph capture makes no attribute
// call.
cudaError_t launch_bwd_wgmma(const BwdArgs& g, int num_experts,
                             int max_tiles, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      grouped_bwd_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      BWD_SMEM);
  if (attr != cudaSuccess) return attr;
  CUtensorMap mdr{}, mdc{}, mw{}, mx{};
  if (!(make_map_f32(&mdr, g.dy, g.n, g.t, 32, 64) &&
        make_map_f32(&mdc, g.dy, g.n, g.t, 32, BWD_PANEL) &&
        wgt::make_map(&mw, g.w, g.n, g.k, num_experts, BWD_PANEL, BWD_TILE,
                      CU_TENSOR_MAP_SWIZZLE_64B) &&
        wgt::make_map(&mx, g.x, g.k, g.t, 1, 64, BWD_PANEL,
                      CU_TENSOR_MAP_SWIZZLE_128B)))
    return cudaErrorInvalidValue;
  const int kb = (g.k + BWD_TILE - 1) / BWD_TILE;
  const int nb = (g.n + BWD_TILE - 1) / BWD_TILE;
  const int64_t n_dx = (int64_t)max_tiles * kb;
  const int64_t n_dw = (int64_t)num_experts * kb * nb;
  if (n_dx + n_dw > 2147483647LL) return cudaErrorInvalidValue;
  grouped_bwd_wgmma<<<(unsigned)(n_dx + n_dw), BWD_THREADS, BWD_SMEM, s>>>(
      mdr, mdc, mw, mx, g, max_tiles, (int)n_dx);
  return cudaGetLastError();
}

// One launch of the bf16 kernel on route R over `tiles` row tiles of bm
// rows.  Route A encodes the tensor maps of this call: A over x (rows, K)
// in K-major boxes of BK x 16 (bm 16) or BK x ABOX, B over w (E, K, N) in
// MN-major boxes of 64 x BK.
template <typename R>
cudaError_t launch_wgmma(const wgt::GemmArgs& g, const GroupSrc& src,
                         int num_experts, int tiles, int bm, int bn,
                         cudaStream_t s) {
  constexpr bool tma = std::is_same<R, wgt::TmaRoute>::value;
  const int smem = tma ? wgt::ring_bytes(src.nwg) : wgt::LD_SMEM;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        grouped_wgmma_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        tma ? wgt::ring_bytes(2) : wgt::LD_SMEM);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  CUtensorMap ma16{}, ma{}, mb{};
  if (tma) {
    const bool ok =
        (bm == 16 ? wgt::make_map(&ma16, g.a, g.k, g.m, 1, wgt::BK, 16,
                                  wgt::KMAJOR_SWIZZLE)
                  : wgt::make_map(&ma, g.a, g.k, g.m, 1, wgt::BK, wgt::ABOX,
                                  wgt::KMAJOR_SWIZZLE)) &&
        wgt::make_map(&mb, g.b, g.n, g.k, num_experts, 64, wgt::BK,
                      CU_TENSOR_MAP_SWIZZLE_128B);
    if (!ok) return cudaErrorInvalidValue;
  }
  const dim3 grid(tiles, (g.n + bn - 1) / bn);
  const int threads = tma ? src.nwg * wgt::WG_THREADS + wgt::PRODUCER_THREADS
                          : wgt::LD_WARPGROUPS * wgt::WG_THREADS;
  grouped_wgmma_kernel<R><<<grid, threads, smem, s>>>(ma16, ma, mb, g, src);
  return cudaGetLastError();
}

// The bf16 forward of either entry point: consumer warpgroups one per 64
// rows of bm (one for bm 16), two on route C.
cudaError_t launch_bf16(const void* x, const void* w, const void* bias,
                        void* out, GroupSrc src, int rows, int tiles, int k,
                        int n, int num_experts, int bm, int bn,
                        int bias_dtype, int epi, int route, cudaStream_t s) {
  const wgt::GemmArgs g{x, w, bias, nullptr, out, rows, n, k, 0,
                        bias_dtype, 0, wgt::DT_BF16, epi};
  src.tiles = tiles;
  if (route == ROUTE_A) {
    src.nwg = bm > 64 ? 2 : 1;
    return launch_wgmma<wgt::TmaRoute>(g, src, num_experts, tiles, bm, bn, s);
  }
  if (route == ROUTE_C) {
    src.nwg = wgt::LD_WARPGROUPS;
    return launch_wgmma<wgt::LdRoute>(g, src, num_experts, tiles, bm, bn, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// route: ROUTE_A (TMA ring) or ROUTE_C (loads through registers) for bf16,
// ignored for fp32.
extern "C" int grouped_fused(const void* x, const void* w, const void* bias,
                             void* out, const int* table, int max_tiles,
                             int t, int k, int n, int num_experts, int bm,
                             int bn, int in_dtype, int bias_dtype, int epi,
                             int route, void* stream) {
  const int shape = find_shape(bm, bn);
  if (shape < 0 || max_tiles <= 0 || t <= 0 || num_experts <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == DT_BF16)
    return launch_bf16(x, w, bias, out, GroupSrc{table, nullptr, nullptr,
                                                 shape, 0, 0},
                       t, max_tiles, k, n, num_experts, bm, bn, bias_dtype,
                       epi, route, s);
  if (in_dtype != DT_F32) return cudaErrorInvalidValue;
  FwdArgs g{x, w, bias, out, k, n, bias_dtype, epi};
  dim3 grid(max_tiles, (n + bn - 1) / bn);
  grouped_fused_kernel<float><<<grid, NT, 0, s>>>(g, table, shape);
  return cudaGetLastError();
}

extern "C" int grouped_padded(const void* x, const void* w, const void* bias,
                              void* out, const int* block_expert,
                              const int* nrows, int t_pad, int k, int n,
                              int num_experts, int bm, int bn, int in_dtype,
                              int bias_dtype, int epi, int route,
                              void* stream) {
  const int shape = find_shape(bm, bn);
  if (shape < 0 || t_pad <= 0 || t_pad % bm || num_experts <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == DT_BF16)
    return launch_bf16(x, w, bias, out, GroupSrc{nullptr, block_expert, nrows,
                                                 shape, 0, 0},
                       t_pad, t_pad / bm, k, n, num_experts, bm, bn,
                       bias_dtype, epi, route, s);
  if (in_dtype != DT_F32) return cudaErrorInvalidValue;
  FwdArgs g{x, w, bias, out, k, n, bias_dtype, epi};
  dim3 grid(t_pad / bm, (n + bn - 1) / bn);
  grouped_padded_kernel<float><<<grid, NT, 0, s>>>(g, block_expert, nrows,
                                                   shape);
  return cudaGetLastError();
}

// route: ROUTE_A (bf16, the TMA ring and wgmma), ROUTE_C (bf16 operands TMA
// cannot read) or ROUTE_F32 (fp32 x and w), the last two on tile_f32.
extern "C" int grouped_bwd(const void* x, const float* dy, const void* w,
                           const int* table, const int* offsets, float* dx,
                           float* dw, float* db, int max_tiles, int t, int k,
                           int n, int num_experts, int bm, int in_dtype,
                           int route, void* stream) {
  if (max_tiles <= 0 || num_experts <= 0 || t <= 0)
    return cudaErrorInvalidValue;
  if ((route == ROUTE_F32) != (in_dtype == DT_F32) ||
      (in_dtype != DT_F32 && in_dtype != DT_BF16) ||
      (route != ROUTE_A && route != ROUTE_C && route != ROUTE_F32))
    return cudaErrorInvalidValue;
  BwdArgs g{x, dy, w, table, offsets, dx, dw, db, t, k, n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == ROUTE_A) {
    if (bm != 16 && bm != 64 && bm != 128) return cudaErrorInvalidValue;
    return launch_bwd_wgmma(g, num_experts, max_tiles, s);
  }
  const int kb = (k + BWD_TK - 1) / BWD_TK, nb = (n + BWD_TN - 1) / BWD_TN;
  const int64_t n_dx = (int64_t)max_tiles * kb;
  const int64_t n_dw = (int64_t)num_experts * kb * nb;
  if (n_dx + n_dw > 2147483647LL) return cudaErrorInvalidValue;
  if (bm == 16) return launch_bwd<16>(g, in_dtype, (int)n_dx, (int)n_dw, s);
  if (bm == 64) return launch_bwd<64>(g, in_dtype, (int)n_dx, (int)n_dw, s);
  if (bm == 128) return launch_bwd<128>(g, in_dtype, (int)n_dx, (int)n_dw, s);
  return cudaErrorInvalidValue;
}
