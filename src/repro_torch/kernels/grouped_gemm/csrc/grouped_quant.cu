// Quantized ragged grouped GEMM (MoE expert compute) for Hopper (sm_90a):
//   out[r] = act(dequant(x[r] @ w[e]) + bias[e]),
//   dequant = sx[r] * sw[e, col]  (sw[e, col] alone for W8A16),
// one launch over the runtime tile table of grouped.cu's grouped_fused.
//
// Replaces the quant branch of the reference package's TPU kernel
// src/repro/kernels/grouped_gemm/kernel.py::build_fused_grouped_kernel
// (quant=, body _fused_grouped_kernel): there the staged operands are the
// wire dtype, accumulation is int32 (int8) or f32 (e4m3, weight-only),
// W8A16 casts the int8 weight tile to x's dtype, and the per-row
// activation scales sx (T, 1) and the per-expert column scales sw (E, N),
// whose row the table-driven index map selects, join the epilogue before
// bias and activation.  Here, as in grouped_fused, one thread block per
// (table row, N block): COMPUTE rows multiply x rows [row0, row_end) by
// expert e's panel, dequantize with sw's row e, add the expert's bias row,
// activate and store the owned rows; ZERO rows store zeros; SKIP rows do
// nothing.
//
// What bounds it on the H100 at the main-path shapes (phi3.5-moe-42b
// under use(quant="int8"), d 4096, 16 experts of d_ff 6400): at decode
// (16 groups of 32 capacity rows) the 419 MB of int8 expert weights a GEMM
// dominate and HBM bounds it, half of the wide kernel's bytes; at prefill
// (16 groups of 256) 215 G int8 operations against the 1,979 TOP/s int8
// peak.
//
// Routes (kernel.py's choose_quant_route picks one a call and counts it):
//   (A) bm >= 64: quant_sm90.cuh's TMA ring with an A map over x (T, K)
//       and a 3-D B map over w (E, K, N), each expert's K extent its own,
//       so TMA's zero fill masks the K and N tails and no panel bleeds into
//       expert e + 1.  int8 x int8 runs int8 wgmma (int32 sums, exact) on
//       the bank re-laid K-major by byte permutes after its load; W8A16 and
//       e4m3 run bf16 wgmma on operands widened after their load.  Tiles
//       are row-aware (wgmma_tile.cuh's 64-row A boxes): the producer loads
//       only the boxes that hold owned rows and a consumer warpgroup with
//       none issues no products, so a 32-row decode group on a bm-128 tile
//       costs one box and one warpgroup's products, not two.
//   (B) bm 16: the same ring swap-AB (the weight columns are wgmma's 64
//       rows, the <= 16 x rows its N).
//   (C) operands TMA cannot read (a base not 16-byte aligned, or a row not
//       a multiple of 16 bytes: int8 K % 16, bf16 K % 8, N % 16):
//       quant_tile.cuh's wmma tile through element-wise loads;
//   (fp32) W8A16 with an fp32 x: quant_tile.cuh's register-blocked FMAs.
// A failed tensor-map encode or launch returns the error; no route falls
// back to another.  Every route stores only [row0, row_end): a tile may
// load x rows it does not own (the next group's, rows past the groups'
// sum, which may hold NaN), but each accumulator row depends on its own x
// row alone, and such rows are never stored.

#include "../../gemm/csrc/quant_sm90.cuh"
#include "../../gemm/csrc/quant_tile.cuh"

namespace {

using namespace quant;

enum { TILE_SKIP = 0, TILE_COMPUTE = 1, TILE_ZERO = 2 };

struct QGroupedArgs {
  const void* x;     // (T, K)
  const void* w;     // (E, K, N)
  const float* sx;   // (T,) row scales, or null (W8A16)
  const float* sw;   // (E, N) column scales per expert
  const void* bias;  // (E, N) or null
  void* out;         // (T, N)
  int k, n;
  int bias_dtype, out_dtype, epi;
};

template <typename S, typename TX, typename TW, int BM, int BN>
__device__ __noinline__ void qtile(const QGroupedArgs g, int row0, int nvalid,
                                   int e, int col0, unsigned char* smem) {
  const TX* x = reinterpret_cast<const TX*>(g.x) + (int64_t)row0 * g.k;
  const TW* w = reinterpret_cast<const TW*>(g.w) + (int64_t)e * g.k * g.n;
  const int k = g.k, n = g.n;
  auto la = [=](int r, int kk) {
    return r < nvalid ? stage<S>(x[(int64_t)r * k + kk]) : zero_of<S>();
  };
  auto lb = [=](int kk, int c) {
    return col0 + c < n ? stage<S>(w[(int64_t)kk * n + col0 + c])
                        : zero_of<S>();
  };
  auto st = [=](int r, int c, float v) {
    const int col = col0 + c;
    if (r >= nvalid || col >= n) return;
    const float s = g.sw[(int64_t)e * n + col];
    const float f = g.sx ? g.sx[row0 + r] * s : s;
    const float bias =
        has_bias(g.epi) ? load_f(g.bias, g.bias_dtype, (int64_t)e * n + col)
                        : 0.f;
    store_f(g.out, g.out_dtype, (int64_t)(row0 + r) * n + col,
            activate(v * f, g.epi, bias));
  };
  tile<S, BM, BN, false>(k, la, lb, st, smem);
}

template <typename S, typename TX, typename TW>
__device__ __forceinline__ void qtile_by_shape(int shape,
                                               const QGroupedArgs& g, int row0,
                                               int nvalid, int e, int col0,
                                               unsigned char* smem) {
  switch (shape) {
    case 0: qtile<S, TX, TW, 16, 64>(g, row0, nvalid, e, col0, smem); break;
    case 1: qtile<S, TX, TW, 16, 128>(g, row0, nvalid, e, col0, smem); break;
    case 2: qtile<S, TX, TW, 64, 64>(g, row0, nvalid, e, col0, smem); break;
    case 3: qtile<S, TX, TW, 64, 128>(g, row0, nvalid, e, col0, smem); break;
    case 4: qtile<S, TX, TW, 128, 64>(g, row0, nvalid, e, col0, smem); break;
    case 5: qtile<S, TX, TW, 128, 128>(g, row0, nvalid, e, col0, smem); break;
    default: break;
  }
}

template <typename S, typename TX, typename TW>
__global__ void __launch_bounds__(NT)
grouped_quant_kernel(QGroupedArgs g, const int* __restrict__ table,
                     int shape) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  const int* row = table + (int64_t)blockIdx.x * 5;
  const int state = row[4];
  if (state == TILE_SKIP) return;
  const int bn = shape_bn(shape), col0 = blockIdx.y * bn;
  const int row0 = row[0], nvalid = row[1] - row[0];
  if (state == TILE_ZERO) {
    for (int i = threadIdx.x; i < nvalid * bn; i += NT) {
      const int c = col0 + i % bn;
      if (c < g.n)
        store_f(g.out, g.out_dtype, (int64_t)(row0 + i / bn) * g.n + c, 0.f);
    }
    return;
  }
  qtile_by_shape<S, TX, TW>(shape, g, row0, nvalid, row[3], col0, smem);
}

int find_shape(int bm, int bn) {
  for (int shape = 0; shape < 6; ++shape)
    if (shape_bm(shape) == bm && shape_bn(shape) == bn) return shape;
  return -1;
}

template <typename S, typename TX, typename TW>
cudaError_t launch_c(const QGroupedArgs& g, const int* table, dim3 grid,
                     int shape, cudaStream_t s) {
  grouped_quant_kernel<S, TX, TW><<<grid, NT, 0, s>>>(g, table, shape);
  return cudaGetLastError();
}

template <typename TW>
cudaError_t launch_wide_x(const QGroupedArgs& g, const int* table, dim3 grid,
                          int shape, int x_dtype, cudaStream_t s) {
  if (x_dtype == DT_BF16)
    return launch_c<__nv_bfloat16, __nv_bfloat16, TW>(g, table, grid, shape,
                                                      s);
  if (x_dtype == DT_F32)
    return launch_c<float, float, TW>(g, table, grid, shape, s);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Routes A and B: quant_sm90.cuh's TMA ring and wgmma.
// ---------------------------------------------------------------------------

enum { ROUTE_A = 0, ROUTE_B = 1, ROUTE_C = 2, ROUTE_F32 = 3 };
// The blocks take the tiles in bands of RASTER_ROWS row tiles, a band
// column by column (grouped.cu's order), so the row tiles of one expert and
// one column block run together and its weight panel is read from HBM
// about once.
constexpr int RASTER_ROWS = 4;

// Rows [row0, row_end) x columns [col0, col0 + bn) of a ZERO tile: zeros,
// in rows of eight columns.
__device__ void zero_rows(const qwg::QArgs& g, int row0, int row_end,
                          int col0, int bn) {
  const int chunks = bn / 8;
  const float v[8] = {};
  for (int q = threadIdx.x; q < (row_end - row0) * chunks; q += blockDim.x) {
    const int r = row0 + q / chunks, c = col0 + q % chunks * 8;
    if (c < g.n)
      wgt::store8(g.out, g.out_dtype, (int64_t)r * g.n + c, 0,
                  min(g.n - c, 8), v);
  }
}

// One block: (table row, column block) in bands of RASTER_ROWS table rows,
// a band column by column.  x's rows are A (the map's rows), the expert's
// panel is B (the map's batch), sw's and the bias's rows are the expert's.
template <typename TX, typename TW>
__global__ void __launch_bounds__(2 * qwg::WG_THREADS + qwg::PRODUCER_THREADS,
                                  2)
grouped_quant_wgmma_kernel(const __grid_constant__ CUtensorMap ma16,
                           const __grid_constant__ CUtensorMap ma,
                           const __grid_constant__ CUtensorMap mb,
                           const __grid_constant__ CUtensorMap mb128,
                           const __grid_constant__ qwg::QArgs g,
                           const int* __restrict__ table, int tiles,
                           int shape, int nwg) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int bn = shape_bn(shape), ncols = gridDim.y;
  const int lin = blockIdx.y * gridDim.x + blockIdx.x;
  const int band = lin / (RASTER_ROWS * ncols);
  const int rows = min(RASTER_ROWS, tiles - band * RASTER_ROWS);
  const int rem = lin - band * RASTER_ROWS * ncols;
  const int* row = table + (int64_t)(band * RASTER_ROWS + rem % rows) * 5;
  const int col0 = (rem / rows) * bn;
  const int state = row[4];
  if (state == TILE_SKIP) return;
  if (state == TILE_ZERO) {
    zero_rows(g, row[0], row[1], col0, bn);
    return;
  }
  const int e = row[3];
  qwg::QTile t;
  t.g = g;
  t.g.sb = g.sb + (int64_t)e * g.n;
  if (wgt::has_bias(g.epi))
    t.g.bias = static_cast<const char*>(g.bias) +
               (int64_t)e * g.n * (g.bias_dtype == DT_BF16 ? 2 : 4);
  t.orow = t.r0 = row[0];
  t.r1 = row[1];
  t.live = row[1] - row[0];
  t.ocol = t.c0 = col0;
  t.c1 = min(col0 + bn, g.n);
  t.bbatch = e;
  t.rank = 0;
  t.split = 1;
  t.nwg = nwg;
  const uint32_t raw = sm90::smem_u32(smem_raw);
  t.smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  qwg::run_by_shape<qwg::Ring<TX, TW>>(shape, t,
                                       qwg::QMaps{&ma16, &ma, &mb, &mb128});
}

template <typename TX, typename TW>
cudaError_t launch_ring(const void* x, const void* w, const qwg::QArgs& g,
                        const int* table, int tiles, int num_experts,
                        int shape, cudaStream_t s) {
  using P = qwg::Pair<TX, TW>;
  auto kernel = grouped_quant_wgmma_kernel<TX, TW>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        P::ring_bytes(2));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  CUtensorMap ma16{}, ma{}, mb{}, mb128{};
  if (!qwg::make_a_maps<TX, TW>(&ma16, &ma, x, g.k, g.m) ||
      !qwg::make_b_maps<TX, TW>(&mb, &mb128, w, g.k, g.n, num_experts, 0))
    return cudaErrorInvalidValue;
  const int nwg = shape_bm(shape) > 64 ? 2 : 1;
  const dim3 grid(tiles, (g.n + shape_bn(shape) - 1) / shape_bn(shape));
  grouped_quant_wgmma_kernel<TX, TW>
      <<<grid, nwg * qwg::WG_THREADS + qwg::PRODUCER_THREADS,
         P::ring_bytes(nwg), s>>>(ma16, ma, mb, mb128, g, table, tiles, shape,
                                  nwg);
  return cudaGetLastError();
}

}  // namespace

// sx null: weight-only (x bf16 or fp32); sx given: x and w both int8 or
// both e4m3.  Dtype codes: 0 fp32, 1 bf16, 2 int8, 3 e4m3.  t: x's rows;
// route: ROUTE_A (bm >= 64) / ROUTE_B (bm 16), the ring; ROUTE_C, the wmma
// tile; ROUTE_F32, fp32 x.
extern "C" int grouped_quant(const void* x, const void* w, const float* sx,
                             const float* sw, const void* bias, void* out,
                             const int* table, int max_tiles, int t, int k,
                             int n, int num_experts, int bm, int bn,
                             int x_dtype, int w_dtype, int bias_dtype,
                             int out_dtype, int epi, int route,
                             void* stream) {
  const int shape = find_shape(bm, bn);
  if (shape < 0 || max_tiles <= 0 || t <= 0 || num_experts <= 0 ||
      sw == nullptr || (out_dtype != DT_F32 && out_dtype != DT_BF16))
    return cudaErrorInvalidValue;
  const bool full = sx != nullptr;
  if (full ? !((x_dtype == DT_I8 && w_dtype == DT_I8) ||
               (x_dtype == DT_E4M3 && w_dtype == DT_E4M3))
           : !((x_dtype == DT_BF16 || x_dtype == DT_F32) &&
               (w_dtype == DT_I8 || w_dtype == DT_E4M3)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == ROUTE_A || route == ROUTE_B) {
    if (x_dtype == DT_F32 || route != (bm == 16 ? ROUTE_B : ROUTE_A))
      return cudaErrorInvalidValue;
    const qwg::QArgs q{sx, sw, bias, out, t, n, k, 0, bias_dtype, out_dtype,
                       epi};
    if (x_dtype == DT_I8)
      return launch_ring<signed char, signed char>(x, w, q, table, max_tiles,
                                                   num_experts, shape, s);
    if (x_dtype == DT_E4M3)
      return launch_ring<__nv_fp8_e4m3, __nv_fp8_e4m3>(
          x, w, q, table, max_tiles, num_experts, shape, s);
    if (w_dtype == DT_I8)
      return launch_ring<__nv_bfloat16, signed char>(
          x, w, q, table, max_tiles, num_experts, shape, s);
    return launch_ring<__nv_bfloat16, __nv_fp8_e4m3>(
        x, w, q, table, max_tiles, num_experts, shape, s);
  }
  if (route != (x_dtype == DT_F32 ? ROUTE_F32 : ROUTE_C))
    return cudaErrorInvalidValue;
  QGroupedArgs g{x, w, sx, sw, bias, out, k, n, bias_dtype, out_dtype, epi};
  dim3 grid(max_tiles, (n + bn - 1) / bn);
  if (full) {
    if (x_dtype == DT_I8)
      return launch_c<signed char, signed char, signed char>(g, table, grid,
                                                             shape, s);
    return launch_c<__nv_bfloat16, __nv_fp8_e4m3, __nv_fp8_e4m3>(
        g, table, grid, shape, s);
  }
  if (w_dtype == DT_I8)
    return launch_wide_x<signed char>(g, table, grid, shape, x_dtype, s);
  return launch_wide_x<__nv_fp8_e4m3>(g, table, grid, shape, x_dtype, s);
}
