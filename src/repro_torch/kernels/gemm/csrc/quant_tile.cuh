// Quantized tile products for Hopper (sm_90a), shared by the quantized
// dense GEMM (gemm_quant.cu) and the quantized grouped GEMM
// (../../grouped_gemm/csrc/grouped_quant.cu) on their route C (operands
// TMA cannot read: a base not 16-byte aligned, or a row not a multiple of
// 16 bytes) and their fp32 route (W8A16 with fp32 activations).  Routes A
// and B, which every main-path call takes, are quant_sm90.cuh's TMA ring.
//
// A tile computes C[BM x BN] = sum_k A(r, k) B(k, c) over a reduction of
// length kdim, reading its operands through loaders la(r, k) / lb(k, c)
// that mask their own row / column edges and return the staged type (the
// tile masks the reduction edge), and hands every element, converted to
// float, to st(r, c, v).  Three tiles, by the staged type:
//   * int8 x int8 (full int8 quant): the tensor cores through wmma with
//     signed char fragments and int32 accumulators.  The sums are exact:
//     at K = 3072 they reach ~5e7, past the 2^24 where an fp32 sum of
//     int8 products stops being exact.  The int32 sum is converted to
//     float (round to nearest) only when it is handed to st.
//     wmma wants 32-byte aligned fragment origins and a leading dimension
//     of 16 bytes or more; an int8 k-step of 16 is 16 bytes, so the
//     panels are staged in 16-wide column blocks ([k/16][BM][16] for A,
//     [c/16][BK][16] for B), each fragment a contiguous 256-byte block.
//   * bf16 x bf16 with fp32 accumulators (wmma 16x16x16): e4m3 operands
//     (full fp8 quant) and the int8 weights of W8A16 are widened to bf16
//     in shared memory, which is exact (int8 needs 7 mantissa bits, e4m3
//     3, and both exponent ranges fit bf16's).
//   * fp32 FMAs, register blocked (W8A16 with fp32 activations; never
//     TF32).
// The dequant factor, bias and activation are the caller's, in st.
//
// One K panel of BK at a time, element-wise loads with bounds checks: the
// loads of a row that is not a multiple of 16 bytes are what route C is
// for.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <mma.h>
#include <stdint.h>
#include <type_traits>

namespace quant {

using namespace nvcuda;

constexpr int NT = 128;  // threads per block, every route and shape
constexpr int BK = 32;   // K panel (H100_SXM.k_panel)
// Largest staging: the fp32 route's two panels at BM = BN = 128.
constexpr int SMEM_BYTES = 2 * BK * (128 + 4) * 4;

enum { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2, DT_E4M3 = 3 };
enum { EPI_NONE = 0, EPI_BIAS, EPI_GELU, EPI_SILU, EPI_RELU, EPI_BIAS_GELU,
       EPI_BIAS_SILU };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(signed char v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 v) {
  return static_cast<float>(v);
}

// An operand element in the staged type S of a route (exact widening).
template <typename S, typename T>
__device__ __forceinline__ S stage(T v) {
  if constexpr (std::is_same<S, T>::value)
    return v;
  else if constexpr (std::is_same<S, float>::value)
    return to_f(v);
  else
    return __float2bfloat16(to_f(v));
}

template <typename S> __device__ __forceinline__ S zero_of() { return S(0); }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

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

// The reference's epilogue order on a dequantized accumulator: + bias
// (already loaded), then the activation (gelu is the tanh approximation).
__device__ __forceinline__ float activate(float x, int epi, float bias) {
  if (epi == EPI_BIAS || epi == EPI_BIAS_GELU || epi == EPI_BIAS_SILU)
    x += bias;
  if (epi == EPI_GELU || epi == EPI_BIAS_GELU) {
    const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
    x = 0.5f * x * (1.f + tanhf(k0 * (x + 0.044715f * x * x * x)));
  } else if (epi == EPI_SILU || epi == EPI_BIAS_SILU) {
    x = x / (1.f + expf(-x));
  } else if (epi == EPI_RELU) {
    x = fmaxf(x, 0.f);
  }
  return x;
}

__device__ __forceinline__ bool has_bias(int epi) {
  return epi == EPI_BIAS || epi == EPI_BIAS_GELU || epi == EPI_BIAS_SILU;
}

// Which index neighbouring threads walk when B is staged: c (B stored
// (K, N), "nn") or k (B stored (N, K), "nt"), so that they read
// neighbouring addresses.
template <bool B_K_FAST>
__device__ __forceinline__ void b_index(int i, int bn, int& kk, int& c) {
  if (B_K_FAST) {
    kk = i % BK;
    c = i / BK;
  } else {
    kk = i / bn;
    c = i % bn;
  }
}

// int8 x int8 -> int32 on the tensor cores.
template <int BM, int BN, bool B_K_FAST, class LA, class LB, class ST>
__device__ __forceinline__ void tile_s8(int kdim, LA la, LB lb, ST st,
                                        unsigned char* smem) {
  constexpr int WARPS_M = BM >= 32 ? 2 : 1;
  constexpr int WARPS_N = 4 / WARPS_M;
  constexpr int WFM = BM / 16 / WARPS_M;
  constexpr int WFN = BN / 16 / WARPS_N;
  signed char* As = reinterpret_cast<signed char*>(smem);  // [BK/16][BM][16]
  signed char* Bs = As + BK * BM;                          // [BN/16][BK][16]
  int* scratch = reinterpret_cast<int*>(Bs + BK * BN);     // 4 x 16x16
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[WFM][WFN];
#pragma unroll
  for (int i = 0; i < WFM; ++i)
#pragma unroll
    for (int j = 0; j < WFN; ++j) wmma::fill_fragment(acc[i][j], 0);

  for (int k0 = 0; k0 < kdim; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK, kk = i % BK;
      As[(kk / 16) * BM * 16 + r * 16 + kk % 16] =
          (k0 + kk < kdim) ? la(r, k0 + kk) : zero_of<signed char>();
    }
    for (int i = tid; i < BK * BN; i += NT) {
      int kk, c;
      b_index<B_K_FAST>(i, BN, kk, c);
      Bs[(c / 16) * BK * 16 + kk * 16 + c % 16] =
          (k0 + kk < kdim) ? lb(k0 + kk, c) : zero_of<signed char>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                     wmma::row_major> fa[WFM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                     wmma::row_major> fb[WFN];
#pragma unroll
      for (int i = 0; i < WFM; ++i)
        wmma::load_matrix_sync(
            fa[i], As + (kk / 16) * BM * 16 + (wm * WFM + i) * 256, 16);
#pragma unroll
      for (int j = 0; j < WFN; ++j)
        wmma::load_matrix_sync(fb[j], Bs + (wn * WFN + j) * BK * 16 + kk * 16,
                               16);
#pragma unroll
      for (int i = 0; i < WFM; ++i)
#pragma unroll
        for (int j = 0; j < WFN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  int* sc = scratch + warp * 256;
#pragma unroll
  for (int i = 0; i < WFM; ++i)
#pragma unroll
    for (int j = 0; j < WFN; ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int fr = (wm * WFM + i) * 16, fc = (wn * WFN + j) * 16;
      for (int e = lane; e < 256; e += 32)
        st(fr + e / 16, fc + e % 16, static_cast<float>(sc[e]));
      __syncwarp();
    }
}

// bf16 x bf16 -> fp32 on the tensor cores (e4m3 and int8 widened).
template <int BM, int BN, bool B_K_FAST, class LA, class LB, class ST>
__device__ __forceinline__ void tile_bf16(int kdim, LA la, LB lb, ST st,
                                          unsigned char* smem) {
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

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[WFM][WFN];
#pragma unroll
  for (int i = 0; i < WFM; ++i)
#pragma unroll
    for (int j = 0; j < WFN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < kdim; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK, kk = i % BK;
      As[r * LDA + kk] =
          (k0 + kk < kdim) ? la(r, k0 + kk) : zero_of<__nv_bfloat16>();
    }
    for (int i = tid; i < BK * BN; i += NT) {
      int kk, c;
      b_index<B_K_FAST>(i, BN, kk, c);
      Bs[kk * LDB + c] =
          (k0 + kk < kdim) ? lb(k0 + kk, c) : zero_of<__nv_bfloat16>();
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
      const int fr = (wm * WFM + i) * 16, fc = (wn * WFN + j) * 16;
      for (int e = lane; e < 256; e += 32)
        st(fr + e / 16, fc + e % 16, sc[e]);
      __syncwarp();
    }
}

// fp32 x fp32 -> fp32, register-blocked FMAs.
template <int BM, int BN, bool B_K_FAST, class LA, class LB, class ST>
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
      const int r = i / BK, kk = i % BK;
      As[kk * LDSA + r] = (k0 + kk < kdim) ? la(r, k0 + kk) : 0.f;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      int kk, c;
      b_index<B_K_FAST>(i, BN, kk, c);
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

// The route of a (staged A, staged B) pair: S is signed char, bf16 or float.
template <typename S, int BM, int BN, bool B_K_FAST, class LA, class LB,
          class ST>
__device__ __forceinline__ void tile(int kdim, LA la, LB lb, ST st,
                                     unsigned char* smem) {
  if constexpr (std::is_same<S, signed char>::value)
    tile_s8<BM, BN, B_K_FAST>(kdim, la, lb, st, smem);
  else if constexpr (std::is_same<S, __nv_bfloat16>::value)
    tile_bf16<BM, BN, B_K_FAST>(kdim, la, lb, st, smem);
  else
    tile_f32<BM, BN, B_K_FAST>(kdim, la, lb, st, smem);
}

// The (bm, bn) palette of the wide kernels (gemm.cu, grouped.cu), in the
// order kernel.py's TEMPLATE_SHAPES / SHAPES list it.
__host__ __device__ inline int shape_bm(int shape) {
  return shape < 2 ? 16 : shape < 4 ? 64 : 128;
}
__host__ __device__ inline int shape_bn(int shape) {
  return shape % 2 ? 128 : 64;
}

}  // namespace quant
