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
//     with no rows writes zero dW and db.
//
// What bounds it on the H100 at the main-path shapes (phi3.5-moe-42b,
// d 4096, 16 experts of d_ff 6400, top-2): a prefill or training step
// sends 4096 capacity rows through each expert GEMM, 2 x 4096 x 4096 x 6400
// = 215 GFLOP against 86 MB of weights and 86 MB of activations, far above
// the ~295 flop/byte ridge: the bf16 tensor cores bound the forward, and
// with 128 x 128 tiles the L2's rate of feeding each SM its K panels; the
// fp32 FMA rate bounds the backward, whose dY is fp32.  Decode sends 512
// rows, 32 an expert: the 839 MB of expert weights per GEMM bound it on
// HBM, and the 32 owned rows of a bm-128 tile are a quarter of its rows.
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
// band's x rows stay in L2 while the panels stream past.  fp32 operands,
// forward and backward, keep register-blocked CUDA-core FMAs (tile_f32;
// never TF32).
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

namespace {

constexpr int NT = 128;  // threads per block of the fp32 kernels
constexpr int BK = 32;   // K (reduction) panel (H100_SXM.grouped_blocks)
constexpr int SMEM_BYTES = 2 * BK * (128 + 4) * 4;  // largest tile, fp32
constexpr int BWD_TK = 64;  // backward: a dX tile's K width, a dW tile's K rows
constexpr int BWD_TN = 64;  // backward: a dW tile's N columns
static_assert(BK == wgt::BK, "the fp32 and wgmma tiles share the K panel");
// The bf16 forward takes its tiles in bands of RASTER_ROWS row tiles, a
// band column by column (block_tile): four is two experts' 128-row tiles
// at phi3.5-moe's prefill, where it was faster than the row-fastest order
// and than bands of 8-32 on the H100.
constexpr int RASTER_ROWS = 4;

enum { EPI_NONE = 0, EPI_BIAS, EPI_GELU, EPI_SILU, EPI_RELU, EPI_BIAS_GELU,
       EPI_BIAS_SILU };
enum { DT_F32 = 0, DT_BF16 = 1 };
enum { TILE_SKIP = 0, TILE_COMPUTE = 1, TILE_ZERO = 2 };
enum { ROUTE_A = 0, ROUTE_C = 2 };

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
  int k, n;
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

extern "C" int grouped_bwd(const void* x, const float* dy, const void* w,
                           const int* table, const int* offsets, float* dx,
                           float* dw, float* db, int max_tiles, int k, int n,
                           int num_experts, int bm, int in_dtype,
                           void* stream) {
  if (max_tiles <= 0 || num_experts <= 0) return cudaErrorInvalidValue;
  BwdArgs g{x, dy, w, table, offsets, dx, dw, db, k, n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kb = (k + BWD_TK - 1) / BWD_TK, nb = (n + BWD_TN - 1) / BWD_TN;
  const int64_t n_dx = (int64_t)max_tiles * kb;
  const int64_t n_dw = (int64_t)num_experts * kb * nb;
  if (n_dx + n_dw > 2147483647LL) return cudaErrorInvalidValue;
  if (bm == 16) return launch_bwd<16>(g, in_dtype, (int)n_dx, (int)n_dw, s);
  if (bm == 64) return launch_bwd<64>(g, in_dtype, (int)n_dx, (int)n_dw, s);
  if (bm == 128) return launch_bwd<128>(g, in_dtype, (int)n_dx, (int)n_dw, s);
  return cudaErrorInvalidValue;
}
