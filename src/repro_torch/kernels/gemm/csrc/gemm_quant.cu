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
// in gemm.cu's gemm_fused, the blocks walk the tile table (row0, col0,
// row_end, col_end, rs, cs, block_id, scale_idx), each computing the
// window at the clamped origin (rs, cs) and storing only the elements it
// owns.  The regions kernel (gemm_region) has no quant form, as the
// reference's build_gemm_kernel has none.
//
// What bounds it on the H100 at the main-path shapes (Qwen3-0.6B's
// projections, d 1024 / q 2048 / d_ff 3072): at decode (M = 8) every
// weight byte is read once for 2 M operations, so HBM bounds it, and one
// byte a weight (int8) is the point of the quant axis: half the bf16
// bytes; with 8-24 tiles of 128 weight columns, so does the number of SMs
// that read them.  At prefill (M = 256) the int8 products are bound by the
// 1,979 TOP/s int8 peak and W8A16 by the 989 TFLOP/s bf16 peak.
//
// Routes (kernel.py's choose_quant_route picks one a call and counts it):
//   (A) every template bm >= 64, and (B) every template bm 16 (decode,
//       swap-AB: the weight columns are wgmma's 64 rows, the activation
//       rows its N): quant_sm90.cuh's TMA ring with int8 wgmma for int8 x
//       int8 (int32 sums, exact) and bf16 wgmma after a widening of the
//       8-bit operands for W8A16 and e4m3.  Where the table has fewer tiles
//       than the card has SMs, kernel.py splits K over a cluster of up to
//       MAX_CLUSTER blocks (split_factor), whose leader reduces in rank
//       order and stores; at decode that is what brings Qwen3's 8-24 tiles
//       to 64-128 blocks, at prefill its 16-48 to 96-128.
//   (C) operands TMA cannot read (a base not 16-byte aligned, or a row not
//       a multiple of 16 bytes: int8 k % 16, bf16 k % 8, an "nn" B's n %
//       16): quant_tile.cuh's wmma tile, one block per table row, one K
//       panel at a time through element-wise loads;
//   (fp32) W8A16 with fp32 activations: quant_tile.cuh's register-blocked
//       FMAs (never TF32).
// A failed tensor-map encode or launch returns the error; no route falls
// back to another.
//
// Masking: routes A and B read through tensor maps with logical extents,
// so TMA fills zeros past every edge; route C replaces out-of-bounds
// operand elements by zero with a select and never reads them.  Padding
// that holds NaN cannot leak in.

#include "quant_sm90.cuh"
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
cudaError_t launch_c(const QGemmArgs& g, const int* table, const int* blocks,
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
    return launch_c<__nv_bfloat16, __nv_bfloat16, TB>(g, table, blocks,
                                                      num_tiles, nt, s);
  if (a_dtype == DT_F32)
    return launch_c<float, float, TB>(g, table, blocks, num_tiles, nt, s);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Routes A and B: quant_sm90.cuh's TMA ring and wgmma.
// ---------------------------------------------------------------------------

constexpr int MAX_CLUSTER = 8;  // split-K blocks (H100_SXM.gemm_max_cluster)

enum { ROUTE_A = 0, ROUTE_B = 1, ROUTE_C = 2, ROUTE_F32 = 3 };

// Table row blockIdx.x / split: the window at the clamped origin (rs, cs),
// the owned rectangle; a cluster's blocks are consecutive in x.
template <typename TA, typename TB>
__global__ void __launch_bounds__(2 * qwg::WG_THREADS + qwg::PRODUCER_THREADS,
                                  2)
gemm_quant_wgmma_kernel(const __grid_constant__ CUtensorMap ma16,
                        const __grid_constant__ CUtensorMap ma,
                        const __grid_constant__ CUtensorMap mb,
                        const __grid_constant__ CUtensorMap mb128,
                        const __grid_constant__ qwg::QArgs g,
                        const int* __restrict__ table,
                        const int* __restrict__ blocks, int split, int nwg) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int* row = table + (int64_t)(blockIdx.x / split) * 8;
  qwg::QTile t;
  t.g = g;
  t.orow = row[4]; t.ocol = row[5];
  t.r0 = row[0]; t.r1 = row[2]; t.c0 = row[1]; t.c1 = row[3];
  t.bbatch = 0;
  t.live = wgt::ALL_ROWS;
  t.split = split;
  t.rank = split > 1 ? (int)sm90::cluster_rank() : 0;
  t.nwg = nwg;
  const uint32_t raw = sm90::smem_u32(smem_raw);
  t.smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  qwg::run_by_shape<qwg::Ring<TA, TB>>(blocks[3 * row[6]], t,
                                       qwg::QMaps{&ma16, &ma, &mb, &mb128});
}

template <typename TA, typename TB>
cudaError_t launch_ring(const void* a, const void* b, const qwg::QArgs& g,
                        const int* table, const int* blocks, int tiles,
                        int split, int nwg, cudaStream_t s) {
  using P = qwg::Pair<TA, TB>;
  auto kernel = gemm_quant_wgmma_kernel<TA, TB>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        P::ring_bytes(2));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  CUtensorMap ma16{}, ma{}, mb{}, mb128{};
  if (!qwg::make_a_maps<TA, TB>(&ma16, &ma, a, g.k, g.m) ||
      !qwg::make_b_maps<TA, TB>(&mb, &mb128, b, g.k, g.n, 1, g.nt))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * split, 1, 1);
  cfg.blockDim = dim3(nwg * qwg::WG_THREADS + qwg::PRODUCER_THREADS);
  cfg.dynamicSmemBytes = P::ring_bytes(nwg);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  if (split > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, kernel, ma16, ma, mb, mb128, g, table, blocks,
                         split, nwg);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

// sa null: weight-only (A bf16 or fp32); sa given: A and B both int8 or
// both e4m3.  Dtype codes: 0 fp32, 1 bf16, 2 int8, 3 e4m3.  route: ROUTE_A
// / ROUTE_B (the ring), ROUTE_C (quant_tile.cuh's wmma tile) or ROUTE_F32
// (fp32 A); split: blocks a tile's K is split over (routes A and B);
// max_bm: the largest template bm in the table (a 128-row tile takes two
// consumer warpgroups).
extern "C" int gemm_quant(const void* a, const void* b, const float* sa,
                          const float* sb, const void* bias, void* out,
                          const int* table, const int* blocks, int num_tiles,
                          int m, int n, int k, int nt, int a_dtype,
                          int b_dtype, int bias_dtype, int out_dtype, int epi,
                          int route, int split, int max_bm, void* stream) {
  if (num_tiles <= 0 || sb == nullptr ||
      (out_dtype != DT_F32 && out_dtype != DT_BF16) || split < 1 ||
      split > MAX_CLUSTER || (split > 1 && route != ROUTE_A &&
                              route != ROUTE_B))
    return cudaErrorInvalidValue;
  const bool full = sa != nullptr;
  if (full ? !((a_dtype == DT_I8 && b_dtype == DT_I8) ||
               (a_dtype == DT_E4M3 && b_dtype == DT_E4M3))
           : !((a_dtype == DT_BF16 || a_dtype == DT_F32) &&
               (b_dtype == DT_I8 || b_dtype == DT_E4M3)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == ROUTE_A || route == ROUTE_B) {
    if (a_dtype == DT_F32) return cudaErrorInvalidValue;
    const qwg::QArgs q{sa, sb, bias, out, m, n, k, nt, bias_dtype, out_dtype,
                       epi};
    const int nwg = route == ROUTE_A && max_bm > 64 ? 2 : 1;
    if (a_dtype == DT_I8)
      return launch_ring<signed char, signed char>(a, b, q, table, blocks,
                                                   num_tiles, split, nwg, s);
    if (a_dtype == DT_E4M3)
      return launch_ring<__nv_fp8_e4m3, __nv_fp8_e4m3>(
          a, b, q, table, blocks, num_tiles, split, nwg, s);
    if (b_dtype == DT_I8)
      return launch_ring<__nv_bfloat16, signed char>(a, b, q, table, blocks,
                                                     num_tiles, split, nwg, s);
    return launch_ring<__nv_bfloat16, __nv_fp8_e4m3>(a, b, q, table, blocks,
                                                      num_tiles, split, nwg, s);
  }
  if (route != (a_dtype == DT_F32 ? ROUTE_F32 : ROUTE_C))
    return cudaErrorInvalidValue;
  QGemmArgs g{a, b, sa, sb, bias, out, m, n, k, bias_dtype, out_dtype, epi};
  if (full) {
    if (a_dtype == DT_I8)
      return launch_c<signed char, signed char, signed char>(g, table, blocks,
                                                             num_tiles, nt, s);
    return launch_c<__nv_bfloat16, __nv_fp8_e4m3, __nv_fp8_e4m3>(
        g, table, blocks, num_tiles, nt, s);
  }
  if (b_dtype == DT_I8)
    return launch_wide_a<signed char>(g, table, blocks, num_tiles, nt,
                                      a_dtype, s);
  return launch_wide_a<__nv_fp8_e4m3>(g, table, blocks, num_tiles, nt,
                                      a_dtype, s);
}
