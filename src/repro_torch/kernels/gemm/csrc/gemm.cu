// Planned GEMM for Hopper (sm_90a): out = epilogue(C? + A @ op(B)).
//
// Replaces the reference package's two TPU GEMM kernels
// (src/repro/kernels/gemm/kernel.py):
//   * gemm_fused  <- build_fused_gemm_kernel (_fused_kernel_body): one
//     launch walks a whole plan's tile table, one thread block per table
//     row, batch as the second grid dimension;
//   * gemm_region <- build_gemm_kernel (_gemm_kernel_body): one launch per
//     plan region, writing straight into the full C (no operand slices,
//     no stitching).
// Both are thin __global__ entry points over one __device__ tile routine
// per (type, shape) that computes a BM x BN window of C and stores only
// the elements the tile owns, so every C element is written by exactly one
// thread block.
//
// What bounds it on the H100 at the main-path shapes (Qwen3-0.6B, batch 4):
//   * prefill projections, M = 1024 (e.g. 1024x1024 @ 1024x3072 bf16):
//     about 400 flops per byte moved, above the card's ~295 flop/byte
//     ridge, so the bound is the tensor cores' 989 TFLOP/s;
//   * decode projections and the tied read-out, M = 4: every weight byte is
//     read once for 8 flops, so the bound is 3.35 TB/s of HBM (the
//     151936 x 1024 bf16 read-out table alone is 311 MB, ~93 us).
// What the simple design does about it: bf16 operands go through the
// tensor cores (nvcuda::wmma 16x16x16, fp32 accumulators); fp32 operands
// use plain fp32 FMAs (never TF32).  The palette has a 16-row shape so a
// decode tile masks 12 of 16 rows instead of 60 of 64.  There is no
// cp.async/TMA pipeline, no wgmma and no persistence yet: loads are
// element-wise with bounds checks, one K panel of 32 at a time.
//
// Masking: out-of-bounds operand elements are replaced by zero with a
// select and never read, so padding that holds NaN cannot leak in.
// The epilogue runs on the fp32 accumulator: + C_in, + bias, activation
// (gelu is the tanh approximation), then the cast to the output type.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int NT = 128;  // threads per block, the same for every shape
constexpr int BK = 32;   // K panel (H100_SXM.k_panel)
constexpr int SMEM_BYTES = 2 * BK * (128 + 4) * 4;  // largest shape, fp32

enum { EPI_NONE = 0, EPI_BIAS, EPI_GELU, EPI_SILU, EPI_RELU, EPI_BIAS_GELU,
       EPI_BIAS_SILU };
enum { DT_F32 = 0, DT_BF16 = 1 };

struct GemmArgs {
  const void* a;
  const void* b;
  const void* bias;  // (n,) or null
  const void* c;     // (nb, m, n) accumulate input or null
  void* out;         // (nb, m, n)
  int m, n, k;
  int nt;            // 1: B is (n, k); 0: B is (k, n)
  int bias_dtype, c_dtype, out_dtype;
  int epi;
};

__device__ __forceinline__ float load_f(const void* p, int dtype, int64_t i) {
  return dtype == DT_BF16
             ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
             : reinterpret_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_f(void* p, int dtype, int64_t i,
                                        float v) {
  if (dtype == DT_BF16)
    reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else
    reinterpret_cast<float*>(p)[i] = v;
}

__device__ __forceinline__ float epilogue(float x, const GemmArgs& g,
                                          int col) {
  const int e = g.epi;
  if (e == EPI_BIAS || e == EPI_BIAS_GELU || e == EPI_BIAS_SILU)
    x += load_f(g.bias, g.bias_dtype, col);
  if (e == EPI_GELU || e == EPI_BIAS_GELU) {
    const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
    x = 0.5f * x * (1.f + tanhf(k0 * (x + 0.044715f * x * x * x)));
  } else if (e == EPI_SILU || e == EPI_BIAS_SILU) {
    x = x / (1.f + expf(-x));
  } else if (e == EPI_RELU) {
    x = fmaxf(x, 0.f);
  }
  return x;
}

// One output element of the tile, if the tile owns it.  C_in joins the
// fp32 accumulator here, before bias and activation (ref_gemm's order).
__device__ __forceinline__ void finish(const GemmArgs& g, int batch, int r,
                                       int c, float acc, int r0, int r1,
                                       int c0, int c1) {
  if (r < r0 || r >= r1 || c < c0 || c >= c1) return;
  const int64_t o = (int64_t)batch * g.m * g.n + (int64_t)r * g.n + c;
  if (g.c) acc += load_f(g.c, g.c_dtype, o);
  store_f(g.out, g.out_dtype, o, epilogue(acc, g, c));
}

// bf16: tensor cores through wmma, fp32 accumulators in registers.
template <int BM, int BN>
__device__ __noinline__ void tile_bf16(const GemmArgs g, int batch,
                                      int orow, int ocol, int r0, int r1,
                                      int c0, int c1, unsigned char* smem) {
  constexpr int LDA = BK + 8;  // padded rows, still 32-byte aligned
  constexpr int LDB = BN + 8;
  constexpr int WARPS_M = BM >= 32 ? 2 : 1;
  constexpr int WARPS_N = 4 / WARPS_M;
  constexpr int WFM = BM / 16 / WARPS_M;
  constexpr int WFN = BN / 16 / WARPS_N;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // BM x LDA
  __nv_bfloat16* Bs = As + BM * LDA;                            // BK x LDB
  float* scratch = reinterpret_cast<float*>(Bs + BK * LDB);     // 4 x 16x16

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const __nv_bfloat16* A =
      reinterpret_cast<const __nv_bfloat16*>(g.a) + (int64_t)batch * g.m * g.k;
  const __nv_bfloat16* B =
      reinterpret_cast<const __nv_bfloat16*>(g.b) + (int64_t)batch * g.k * g.n;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[WFM][WFN];
#pragma unroll
  for (int i = 0; i < WFM; ++i)
#pragma unroll
    for (int j = 0; j < WFN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < g.k; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK, kk = i % BK, gr = orow + r, gk = k0 + kk;
      As[r * LDA + kk] =
          (gr < g.m && gk < g.k) ? A[(int64_t)gr * g.k + gk] : zero;
    }
    if (!g.nt) {
      for (int i = tid; i < BK * BN; i += NT) {
        const int kk = i / BN, cc = i % BN, gk = k0 + kk, gc = ocol + cc;
        Bs[kk * LDB + cc] =
            (gk < g.k && gc < g.n) ? B[(int64_t)gk * g.n + gc] : zero;
      }
    } else {
      for (int i = tid; i < BK * BN; i += NT) {
        const int cc = i / BK, kk = i % BK, gk = k0 + kk, gc = ocol + cc;
        Bs[kk * LDB + cc] =
            (gk < g.k && gc < g.n) ? B[(int64_t)gc * g.k + gk] : zero;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[WFM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[WFN];
#pragma unroll
      for (int i = 0; i < WFM; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * WFM + i) * 16 * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < WFN; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * LDB + (wn * WFN + j) * 16, LDB);
#pragma unroll
      for (int i = 0; i < WFM; ++i)
#pragma unroll
        for (int j = 0; j < WFN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* sc = scratch + warp * 256;
#pragma unroll
  for (int i = 0; i < WFM; ++i)
#pragma unroll
    for (int j = 0; j < WFN; ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int fr = orow + (wm * WFM + i) * 16;
      const int fc = ocol + (wn * WFN + j) * 16;
      for (int e = lane; e < 256; e += 32)
        finish(g, batch, fr + e / 16, fc + e % 16, sc[e], r0, r1, c0, c1);
      __syncwarp();
    }
}

// fp32: register-blocked fp32 FMAs (no TF32).
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

template <typename T, int BM, int BN>
__device__ __forceinline__ void tile(const GemmArgs& g, int batch, int orow,
                                     int ocol, int r0, int r1, int c0, int c1,
                                     unsigned char* smem) {
  if constexpr (std::is_same<T, float>::value)
    tile_f32<BM, BN>(g, batch, orow, ocol, r0, r1, c0, c1, smem);
  else
    tile_bf16<BM, BN>(g, batch, orow, ocol, r0, r1, c0, c1, smem);
}

// The palette, in the order kernel.py's TEMPLATE_SHAPES lists it.  Each
// (type, shape) tile routine is compiled once (__noinline__) and shared by
// both entry points.
__host__ __device__ inline int shape_bm(int shape) {
  return shape < 2 ? 16 : shape < 4 ? 64 : 128;
}
__host__ __device__ inline int shape_bn(int shape) {
  return shape % 2 ? 128 : 64;
}

template <typename T>
__device__ __forceinline__ void tile_by_shape(int shape, const GemmArgs& g,
                                              int batch, int orow, int ocol,
                                              int r0, int r1, int c0, int c1,
                                              unsigned char* smem) {
  switch (shape) {
    case 0: tile<T, 16, 64>(g, batch, orow, ocol, r0, r1, c0, c1, smem); break;
    case 1: tile<T, 16, 128>(g, batch, orow, ocol, r0, r1, c0, c1, smem); break;
    case 2: tile<T, 64, 64>(g, batch, orow, ocol, r0, r1, c0, c1, smem); break;
    case 3: tile<T, 64, 128>(g, batch, orow, ocol, r0, r1, c0, c1, smem); break;
    case 4: tile<T, 128, 64>(g, batch, orow, ocol, r0, r1, c0, c1, smem); break;
    case 5: tile<T, 128, 128>(g, batch, orow, ocol, r0, r1, c0, c1, smem); break;
    default: break;
  }
}

// One thread block per tile-table row (row0, col0, row_end, col_end, rs,
// cs, block_id, scale_idx); blockIdx.y is the batch.  The window sits at
// the clamped origin (rs, cs); blocks[3 * block_id] names its shape.
template <typename T>
__global__ void __launch_bounds__(NT)
gemm_fused_kernel(GemmArgs g, const int* __restrict__ table,
                  const int* __restrict__ blocks) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  const int* row = table + (int64_t)blockIdx.x * 8;
  tile_by_shape<T>(blocks[3 * row[6]], g, blockIdx.y, row[4], row[5], row[0],
                   row[2], row[1], row[3], smem);
}

// One region's (ceil(rows/BM), ceil(cols/BN), nb) grid of one shape.
template <typename T>
__global__ void __launch_bounds__(NT)
gemm_region_kernel(GemmArgs g, int shape, int row0, int col0, int rows,
                   int cols) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  const int bm = shape_bm(shape), bn = shape_bn(shape);
  const int orow = row0 + blockIdx.x * bm, ocol = col0 + blockIdx.y * bn;
  tile_by_shape<T>(shape, g, blockIdx.z, orow, ocol, orow,
                   min(orow + bm, row0 + rows), ocol,
                   min(ocol + bn, col0 + cols), smem);
}

template <typename T>
cudaError_t launch_region(const GemmArgs& g, int row0, int col0, int rows,
                          int cols, int bm, int bn, int nb, cudaStream_t s) {
  for (int shape = 0; shape < 6; ++shape) {
    if (shape_bm(shape) != bm || shape_bn(shape) != bn) continue;
    dim3 grid((rows + bm - 1) / bm, (cols + bn - 1) / bn, nb);
    gemm_region_kernel<T><<<grid, NT, 0, s>>>(g, shape, row0, col0, rows,
                                              cols);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int gemm_fused(const void* a, const void* b, const void* bias,
                          const void* c, void* out, const int* table,
                          const int* blocks, int num_tiles, int nb, int m,
                          int n, int k, int nt, int in_dtype, int bias_dtype,
                          int c_dtype, int out_dtype, int epi, void* stream) {
  GemmArgs g{a, b, bias, c, out, m, n, k, nt, bias_dtype, c_dtype, out_dtype,
             epi};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(num_tiles, nb);
  if (in_dtype == DT_BF16)
    gemm_fused_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(g, table, blocks);
  else if (in_dtype == DT_F32)
    gemm_fused_kernel<float><<<grid, NT, 0, s>>>(g, table, blocks);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

extern "C" int gemm_region(const void* a, const void* b, const void* bias,
                           const void* c, void* out, int row0, int col0,
                           int rows, int cols, int bm, int bn, int nb, int m,
                           int n, int k, int nt, int in_dtype, int bias_dtype,
                           int c_dtype, int out_dtype, int epi,
                           void* stream) {
  GemmArgs g{a, b, bias, c, out, m, n, k, nt, bias_dtype, c_dtype, out_dtype,
             epi};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == DT_BF16)
    return launch_region<__nv_bfloat16>(g, row0, col0, rows, cols, bm, bn, nb, s);
  if (in_dtype == DT_F32)
    return launch_region<float>(g, row0, col0, rows, cols, bm, bn, nb, s);
  return cudaErrorInvalidValue;
}
