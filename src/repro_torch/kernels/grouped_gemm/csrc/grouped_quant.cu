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
// expert e's panel through quant_tile.cuh's routes (int8: int32 on the
// tensor cores, exact; e4m3, or a bf16 x with an int8 / e4m3 w: bf16 on
// the tensor cores with fp32 sums; an fp32 x: fp32 FMAs), dequantize
// with sw's row e, add the expert's bias row, activate and store the
// owned rows; ZERO rows store zeros; SKIP rows do nothing.
//
// What bounds it on the H100 at the main-path shapes (phi3.5-moe-42b
// under use(quant="int8"), d 4096, 16 experts of d_ff 6400): at decode
// (512 capacity rows) the 419 MB of int8 expert weights a GEMM dominate
// and HBM bounds it, half of the wide kernel's bytes; at prefill (4096
// rows) 215 G int8 operations against the 1,979 TOP/s int8 peak.  The
// design is the wide kernel's: element-wise loads, one K panel of 32.

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
cudaError_t launch(const QGroupedArgs& g, const int* table, dim3 grid,
                   int shape, cudaStream_t s) {
  grouped_quant_kernel<S, TX, TW><<<grid, NT, 0, s>>>(g, table, shape);
  return cudaGetLastError();
}

template <typename TW>
cudaError_t launch_wide_x(const QGroupedArgs& g, const int* table, dim3 grid,
                          int shape, int x_dtype, cudaStream_t s) {
  if (x_dtype == DT_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16, TW>(g, table, grid, shape, s);
  if (x_dtype == DT_F32) return launch<float, float, TW>(g, table, grid, shape, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// sx null: weight-only (x bf16 or fp32); sx given: x and w both int8 or
// both e4m3.  Dtype codes: 0 fp32, 1 bf16, 2 int8, 3 e4m3.
extern "C" int grouped_quant(const void* x, const void* w, const float* sx,
                             const float* sw, const void* bias, void* out,
                             const int* table, int max_tiles, int k, int n,
                             int bm, int bn, int x_dtype, int w_dtype,
                             int bias_dtype, int out_dtype, int epi,
                             void* stream) {
  const int shape = find_shape(bm, bn);
  if (shape < 0 || max_tiles <= 0 || sw == nullptr ||
      (out_dtype != DT_F32 && out_dtype != DT_BF16))
    return cudaErrorInvalidValue;
  QGroupedArgs g{x, w, sx, sw, bias, out, k, n, bias_dtype, out_dtype, epi};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(max_tiles, (n + bn - 1) / bn);
  if (sx != nullptr) {
    if (x_dtype == DT_I8 && w_dtype == DT_I8)
      return launch<signed char, signed char, signed char>(g, table, grid,
                                                           shape, s);
    if (x_dtype == DT_E4M3 && w_dtype == DT_E4M3)
      return launch<__nv_bfloat16, __nv_fp8_e4m3, __nv_fp8_e4m3>(
          g, table, grid, shape, s);
    return cudaErrorInvalidValue;
  }
  if (w_dtype == DT_I8)
    return launch_wide_x<signed char>(g, table, grid, shape, x_dtype, s);
  if (w_dtype == DT_E4M3)
    return launch_wide_x<__nv_fp8_e4m3>(g, table, grid, shape, x_dtype, s);
  return cudaErrorInvalidValue;
}
