// Shared device code of the SSD chunked-scan kernels (ssd_scan.cu and
// ssd_scan_bwd.cu): the kernels' geometry limits, operands whose type
// (float32 or bfloat16) is chosen at run time, tile loads into shared
// memory as fp32, and a block-wide small product on CUDA cores.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace ssd {

constexpr int NT = 256;     // threads a block
constexpr int Q_MAX = 256;  // chunk length
constexpr int N_MAX = 128;  // state size
constexpr int P_MAX = 64;   // head dim

// A float32 or bfloat16 operand; the branch is the same for every thread.
struct Operand {
  const void* ptr;
  int bf16;
  __device__ __forceinline__ float operator[](int64_t i) const {
    return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(ptr)[i])
                : static_cast<const float*>(ptr)[i];
  }
};

// v rounded to bfloat16 (round to nearest even) when bf16, else v.
__device__ __forceinline__ float round_to(float v, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16(v)) : v;
}

__device__ __forceinline__ void store(void* out, int bf16, int64_t i,
                                      float v) {
  if (bf16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(out)[i] = v;
}

// rows x cols elements of src (row stride src_ld, from element base) into
// dst (row stride ld) as fp32; neighbouring threads read neighbouring
// elements.
template <typename Src>
__device__ __forceinline__ void load_tile(float* dst, int ld, const Src& src,
                                          int64_t base, int rows, int cols,
                                          int src_ld) {
  for (int i = threadIdx.x; i < rows * cols; i += NT) {
    const int r = i / cols, c = i - r * cols;
    dst[r * ld + c] = src[base + (int64_t)r * src_ld + c];
  }
}

// out(m, c, Σ_k A(m, k) B(c, k)) for every m < M, c < N, over the block.
// Each thread owns 4x4 micro-tiles whose rows are strided by ceil(M / 4)
// and whose columns by ceil(N / 4), so that neighbouring threads read
// neighbouring rows of B (B's rows padded to an odd stride hit distinct
// banks) and few distinct rows of A (broadcast).  Every (m, c) has exactly
// one owner, which depends only on (M, N): products over the same (M, N)
// hand each output to the same thread.  Rows and columns past the edge
// are clamped for the loads and never stored.
template <typename FA, typename FB, typename FOut>
__device__ __forceinline__ void block_mm(int M, int N, int K, FA A, FB B,
                                         FOut out) {
  const int tm = (M + 3) >> 2, tn = (N + 3) >> 2;
  for (int t = threadIdx.x; t < tm * tn; t += NT) {
    const int mi = t / tn, ni = t - mi * tn;
    int rows[4], cols[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) rows[a] = min(mi + tm * a, M - 1);
#pragma unroll
    for (int b = 0; b < 4; ++b) cols[b] = min(ni + tn * b, N - 1);
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll 2
    for (int k = 0; k < K; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = A(rows[a], k);
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = B(cols[b], k);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int m = mi + tm * a;
      if (m >= M) continue;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int c = ni + tn * b;
        if (c < N) out(m, c, acc[a][b]);
      }
    }
  }
}

template <typename Kernel, typename Args>
cudaError_t launch(Kernel kernel, int blocks, size_t smem, void* stream,
                   const Args& args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<blocks, NT, smem, static_cast<cudaStream_t>(stream)>>>(args);
  return cudaGetLastError();
}

inline bool geometry_ok(int groups, int chunks, int q, int n, int p) {
  return groups >= 1 && chunks >= 1 && q >= 1 && q <= Q_MAX && n >= 1 &&
         n <= N_MAX && p >= 1 && p <= P_MAX;
}

}  // namespace ssd
