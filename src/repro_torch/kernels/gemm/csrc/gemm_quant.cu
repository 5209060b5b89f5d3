// Quantized planned GEMM for Hopper (sm_90a):
//   out = act(dequant(A @ op(B)) + bias),  dequant = sa[row] * sb[col]
// (sb[col] alone for W8A16), one launch over a plan's tile table.
//
// Replaces the quant branch of the reference package's TPU kernel
// src/repro/kernels/gemm/kernel.py::build_fused_gemm_kernel (quant=, body
// _fused_kernel_body): there the operands arrive in the wire dtype, the
// accumulator scratch is int32 (int8) or f32 (e4m3, weight-only), W8A16
// casts the int8 weight tile to A's dtype before the MXU dot, and the
// expanded f32 scale vectors sa (m, 1) and sb (1, n), windowed by the
// tile's origin, join the epilogue before bias and activation.  Here, as
// in gemm.cu's gemm_fused, one thread block per tile-table row (row0,
// col0, row_end, col_end, rs, cs, block_id, scale_idx) computes the window
// at the clamped origin (rs, cs) and stores only the elements it owns.
// The tile routes are quant_tile.cuh's:
//   * int8 A and B (full int8 quant): int32 on the tensor cores, exact;
//   * e4m3 A and B (full fp8 quant), or bf16 A with an int8 / e4m3 B
//     (W8A16): widened to bf16 in shared memory, fp32 accumulators;
//   * fp32 A with an int8 / e4m3 B: fp32 FMAs.
// The regions kernel (gemm_region) has no quant form, as the reference's
// build_gemm_kernel has none.
//
// What bounds it on the H100 at the main-path shapes (Qwen3-0.6B's
// projections, d 1024 / q 2048 / d_ff 3072): at decode (M = 4-8) every
// weight byte is read once for 2 M operations, so HBM bounds it, and one
// byte a weight (int8) is the point of the quant axis: half the bf16
// bytes.  At prefill (M = 1024) the int8 products are bound by the 1,979
// TOP/s int8 peak and W8A16 by the 989 TFLOP/s bf16 peak.  The simple
// design stages one K panel of 32 at a time with element-wise loads, as
// gemm.cu does; TMA, wgmma and a pipeline are later work.
//
// Masking: out-of-bounds operand elements are replaced by zero with a
// select and never read, so padding that holds NaN cannot leak in.

#include "quant_tile.cuh"

namespace {

using namespace quant;

struct QGemmArgs {
  const void* a;     // (m, k)
  const void* b;     // (k, n) or (n, k)
  const float* sa;   // (m,) row scales, or null (W8A16)
  const float* sb;   // (n,) column scales
  const void* bias;  // (n,) or null
  void* out;         // (m, n)
  int m, n, k;
  int bias_dtype, out_dtype, epi;
};

// One tile: window (orow, ocol) of shape (BM, BN), owned rows [r0, r1) and
// columns [c0, c1).  S is the route's staged type, TA / TB the operands'.
template <typename S, typename TA, typename TB, bool NT_B, int BM, int BN>
__device__ __noinline__ void qtile(const QGemmArgs g, int orow, int ocol,
                                   int r0, int r1, int c0, int c1,
                                   unsigned char* smem) {
  const TA* A = reinterpret_cast<const TA*>(g.a);
  const TB* B = reinterpret_cast<const TB*>(g.b);
  const int m = g.m, n = g.n, k = g.k;
  auto la = [=](int r, int kk) {
    const int gr = orow + r;
    return gr < m ? stage<S>(A[(int64_t)gr * k + kk]) : zero_of<S>();
  };
  auto lb = [=](int kk, int c) {
    const int gc = ocol + c;
    if (gc >= n) return zero_of<S>();
    return stage<S>(NT_B ? B[(int64_t)gc * k + kk] : B[(int64_t)kk * n + gc]);
  };
  auto st = [=](int r, int c, float v) {
    const int gr = orow + r, gc = ocol + c;
    if (gr < r0 || gr >= r1 || gc < c0 || gc >= c1) return;
    const float f = g.sa ? g.sa[gr] * g.sb[gc] : g.sb[gc];
    const float bias = has_bias(g.epi) ? load_f(g.bias, g.bias_dtype, gc) : 0.f;
    store_f(g.out, g.out_dtype, (int64_t)gr * n + gc,
            activate(v * f, g.epi, bias));
  };
  tile<S, BM, BN, NT_B>(k, la, lb, st, smem);
}

template <typename S, typename TA, typename TB, bool NT_B>
__device__ __forceinline__ void qtile_by_shape(int shape, const QGemmArgs& g,
                                               int orow, int ocol, int r0,
                                               int r1, int c0, int c1,
                                               unsigned char* smem) {
  switch (shape) {
    case 0: qtile<S, TA, TB, NT_B, 16, 64>(g, orow, ocol, r0, r1, c0, c1, smem); break;
    case 1: qtile<S, TA, TB, NT_B, 16, 128>(g, orow, ocol, r0, r1, c0, c1, smem); break;
    case 2: qtile<S, TA, TB, NT_B, 64, 64>(g, orow, ocol, r0, r1, c0, c1, smem); break;
    case 3: qtile<S, TA, TB, NT_B, 64, 128>(g, orow, ocol, r0, r1, c0, c1, smem); break;
    case 4: qtile<S, TA, TB, NT_B, 128, 64>(g, orow, ocol, r0, r1, c0, c1, smem); break;
    case 5: qtile<S, TA, TB, NT_B, 128, 128>(g, orow, ocol, r0, r1, c0, c1, smem); break;
    default: break;
  }
}

// One thread block per tile-table row; blocks[3 * block_id] names its shape.
template <typename S, typename TA, typename TB, bool NT_B>
__global__ void __launch_bounds__(NT)
gemm_quant_kernel(QGemmArgs g, const int* __restrict__ table,
                  const int* __restrict__ blocks) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  const int* row = table + (int64_t)blockIdx.x * 8;
  qtile_by_shape<S, TA, TB, NT_B>(blocks[3 * row[6]], g, row[4], row[5],
                                  row[0], row[2], row[1], row[3], smem);
}

template <typename S, typename TA, typename TB>
cudaError_t launch(const QGemmArgs& g, const int* table, const int* blocks,
                   int num_tiles, int nt, cudaStream_t s) {
  if (nt)
    gemm_quant_kernel<S, TA, TB, true><<<num_tiles, NT, 0, s>>>(g, table,
                                                                 blocks);
  else
    gemm_quant_kernel<S, TA, TB, false><<<num_tiles, NT, 0, s>>>(g, table,
                                                                  blocks);
  return cudaGetLastError();
}

// W8A16-style pairs: a wide A with a narrow B of type TB.
template <typename TB>
cudaError_t launch_wide_a(const QGemmArgs& g, const int* table,
                          const int* blocks, int num_tiles, int nt,
                          int a_dtype, cudaStream_t s) {
  if (a_dtype == DT_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16, TB>(g, table, blocks,
                                                    num_tiles, nt, s);
  if (a_dtype == DT_F32)
    return launch<float, float, TB>(g, table, blocks, num_tiles, nt, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// sa null: weight-only (A bf16 or fp32); sa given: A and B both int8 or
// both e4m3.  Dtype codes: 0 fp32, 1 bf16, 2 int8, 3 e4m3.
extern "C" int gemm_quant(const void* a, const void* b, const float* sa,
                          const float* sb, const void* bias, void* out,
                          const int* table, const int* blocks, int num_tiles,
                          int m, int n, int k, int nt, int a_dtype,
                          int b_dtype, int bias_dtype, int out_dtype, int epi,
                          void* stream) {
  if (num_tiles <= 0 || sb == nullptr ||
      (out_dtype != DT_F32 && out_dtype != DT_BF16))
    return cudaErrorInvalidValue;
  QGemmArgs g{a, b, sa, sb, bias, out, m, n, k, bias_dtype, out_dtype, epi};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sa != nullptr) {
    if (a_dtype == DT_I8 && b_dtype == DT_I8)
      return launch<signed char, signed char, signed char>(g, table, blocks,
                                                           num_tiles, nt, s);
    if (a_dtype == DT_E4M3 && b_dtype == DT_E4M3)
      return launch<__nv_bfloat16, __nv_fp8_e4m3, __nv_fp8_e4m3>(
          g, table, blocks, num_tiles, nt, s);
    return cudaErrorInvalidValue;
  }
  if (b_dtype == DT_I8)
    return launch_wide_a<signed char>(g, table, blocks, num_tiles, nt,
                                      a_dtype, s);
  if (b_dtype == DT_E4M3)
    return launch_wide_a<__nv_fp8_e4m3>(g, table, blocks, num_tiles, nt,
                                        a_dtype, s);
  return cudaErrorInvalidValue;
}
