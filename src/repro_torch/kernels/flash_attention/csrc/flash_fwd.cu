// Flash-attention forward for Hopper (sm_90a): o = softmax(q k^T * d^-0.5) v,
// causal or not, over (BH, s, d) operands, online softmax with an m/l/acc
// carry per query row.
//
// Replaces the reference package's two TPU forward kernels
// (src/repro/kernels/flash_attention/kernel.py):
//   * flash_fwd_fused <- build_fused_flash_kernel (_fused_flash_kernel):
//     grid (q_blocks, BH); each thread block walks its q-block's contiguous
//     run of FlashTileSchedule rows, so causal k-blocks dropped at plan time
//     are never touched; the carry resets at `first`, drains at `last`
//     into the owned rows [q0, q_end) only;
//   * flash_fwd_dense <- build_flash_kernel (_flash_kernel): grid
//     (ceil(sq/bq), BH); every k-block is visited in order and those past
//     the causal diagonal (ki*bk > qi*bq + bq - 1) are skipped; the KV tail
//     is masked and V rows at or past sk are zero.
//
// Numerics follow the reference exactly where it matters: masked scores are
// NEG_INF = -1e30 (not -inf, so a row whose first tiles are fully masked
// carries p = 1 until a real score washes it out through alpha instead of
// producing NaN); P is rounded to V's type before the PV product; the drain
// divides by max(l, 1e-30).  The causal diagonal is start-aligned
// (kpos <= qpos), which equals the end-aligned oracle only when sq == sk --
// the model's only causal call.
//
// What bounds it on the H100 at the main-path shape (BH = 64 = batch 4 x 16
// heads, sq = sk = 256, d = 128, causal, bf16): 1.07 GFLOP of useful work
// against 16.8 MB of q/k/v/o, ~64 flop/byte, below the ~295 flop/byte ridge:
// the bound is bytes (5.0 us at 3.35 TB/s) -- but at this size the launch
// and the thread blocks' serial tile walk dominate.  The simple design: fp32
// math on CUDA cores from tiles staged in shared memory (q, k, v, the score
// tile and the output accumulator all stay on chip for a q-block's walk), a
// 64 x 64 tile, 128 threads.  Tensor-core QK^T/PV, cp.async/TMA double
// buffering and GQA folded into the kernel are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;
constexpr int BQ_MAX = 64;
constexpr int BK_MAX = 64;
constexpr int D_MAX = 128;
constexpr float NEG_INF = -1e30f;

struct FlashArgs {
  const void* q;  // (BH, sq, d)
  const void* k;  // (BH, sk, d)
  const void* v;  // (BH, sk, d)
  void* o;        // (BH, sq, d)
  int sq, sk, d, bq, bk, causal;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared-memory carve-up (floats): q, k (padded rows), v, scores (padded
// rows), output accumulator, and the per-row m / l / alpha.
struct Smem {
  float *q, *k, *v, *s, *acc, *m, *l, *alpha;
  __device__ Smem(float* base, int bq, int bk, int d) {
    q = base;
    k = q + bq * d;
    v = k + bk * (d + 1);
    s = v + bk * d;
    acc = s + bq * (bk + 1);
    m = acc + bq * d;
    l = m + bq;
    alpha = l + bq;
  }
};

__device__ __forceinline__ void carry_init(const Smem& sm, int bq, int d) {
  for (int i = threadIdx.x; i < bq * d; i += NT) sm.acc[i] = 0.f;
  for (int i = threadIdx.x; i < bq; i += NT) {
    sm.m[i] = NEG_INF;
    sm.l[i] = 0.f;
  }
}

// Rows [row0, row0 + rows) of a (len, d) slice, zero past `len`.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          int row0, int rows, int len, int d) {
  for (int i = threadIdx.x; i < rows * d; i += NT) {
    const int r = i / d, c = i % d, gr = row0 + r;
    dst[r * ld + c] = gr < len ? to_f(src[(int64_t)gr * d + c]) : 0.f;
  }
}

// One online-softmax step: the k/v window at `ks`, scores valid where
// k_lo <= kpos < k_hi and (!causal || kpos <= qpos), qpos = qs + row.
template <typename T>
__device__ void attend_tile(const FlashArgs& f, const Smem& sm, const T* K,
                            const T* V, int qs, int ks, int k_lo, int k_hi) {
  const int bq = f.bq, bk = f.bk, d = f.d;
  __syncthreads();  // previous tile's readers of k/v/s are done
  load_rows<T>(sm.k, d + 1, K, ks, bk, f.sk, d);
  load_rows<T>(sm.v, d, V, ks, bk, f.sk, d);
  __syncthreads();
  for (int i = threadIdx.x; i < bq * bk; i += NT) {
    const int r = i / bk, j = i % bk;
    const float* qr = sm.q + r * d;
    const float* kr = sm.k + j * (d + 1);
    float dot = 0.f;
    for (int c = 0; c < d; ++c) dot = fmaf(qr[c], kr[c], dot);
    const int kpos = ks + j, qpos = qs + r;
    const bool valid = kpos >= k_lo && kpos < k_hi &&
                       (!f.causal || kpos <= qpos);
    sm.s[r * (bk + 1) + j] = valid ? dot * f.scale : NEG_INF;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < bq; r += NT) {
    float* sr = sm.s + r * (bk + 1);
    const float m_prev = sm.m[r];
    float m_new = m_prev;
    for (int j = 0; j < bk; ++j) m_new = fmaxf(m_new, sr[j]);
    float sum = 0.f;
    for (int j = 0; j < bk; ++j) {
      const float p = expf(sr[j] - m_new);
      sum += p;
      sr[j] = to_f(from_f<T>(p));  // P in V's type for the PV product
    }
    const float alpha = expf(m_prev - m_new);
    sm.l[r] = sm.l[r] * alpha + sum;
    sm.m[r] = m_new;
    sm.alpha[r] = alpha;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < bq * d; i += NT) {
    const int r = i / d, c = i % d;
    const float* pr = sm.s + r * (bk + 1);
    float pv = 0.f;
    for (int j = 0; j < bk; ++j) pv = fmaf(pr[j], sm.v[j * d + c], pv);
    sm.acc[i] = sm.acc[i] * sm.alpha[r] + pv;
  }
}

// Normalised output of the carry for window rows [qs, qs + bq) that fall in
// [o_lo, o_hi).
template <typename T>
__device__ void drain(const FlashArgs& f, const Smem& sm, T* O, int qs,
                      int o_lo, int o_hi) {
  __syncthreads();
  for (int i = threadIdx.x; i < f.bq * f.d; i += NT) {
    const int r = i / f.d, c = i % f.d, qpos = qs + r;
    if (qpos >= o_lo && qpos < o_hi)
      O[(int64_t)qpos * f.d + c] = from_f<T>(sm.acc[i] / fmaxf(sm.l[r], 1e-30f));
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
flash_fused_kernel(FlashArgs f, const int* __restrict__ table,
                   const int* __restrict__ qindex) {
  extern __shared__ float smem[];
  const Smem sm(smem, f.bq, f.bk, f.d);
  const int64_t bh = blockIdx.y;
  const T* Q = reinterpret_cast<const T*>(f.q) + bh * f.sq * f.d;
  const T* K = reinterpret_cast<const T*>(f.k) + bh * f.sk * f.d;
  const T* V = reinterpret_cast<const T*>(f.v) + bh * f.sk * f.d;
  T* O = reinterpret_cast<T*>(f.o) + bh * f.sq * f.d;
  const int start = qindex[2 * blockIdx.x], count = qindex[2 * blockIdx.x + 1];
  const int qs = table[start * 8 + 2];
  load_rows<T>(sm.q, f.d, Q, qs, f.bq, f.sq, f.d);
  for (int t = start; t < start + count; ++t) {
    const int* row = table + (int64_t)t * 8;  // q0 q_end qs k0 k_end ks first last
    if (row[6]) {
      __syncthreads();
      carry_init(sm, f.bq, f.d);
    }
    attend_tile<T>(f, sm, K, V, qs, row[5], row[3], row[4]);
    if (row[7]) drain<T>(f, sm, O, qs, row[0], row[1]);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) flash_dense_kernel(FlashArgs f) {
  extern __shared__ float smem[];
  const Smem sm(smem, f.bq, f.bk, f.d);
  const int64_t bh = blockIdx.y;
  const T* Q = reinterpret_cast<const T*>(f.q) + bh * f.sq * f.d;
  const T* K = reinterpret_cast<const T*>(f.k) + bh * f.sk * f.d;
  const T* V = reinterpret_cast<const T*>(f.v) + bh * f.sk * f.d;
  T* O = reinterpret_cast<T*>(f.o) + bh * f.sq * f.d;
  const int q0 = blockIdx.x * f.bq;
  load_rows<T>(sm.q, f.d, Q, q0, f.bq, f.sq, f.d);
  carry_init(sm, f.bq, f.d);
  const int k_steps = (f.sk + f.bk - 1) / f.bk;
  for (int ki = 0; ki < k_steps; ++ki) {
    if (f.causal && ki * f.bk > q0 + f.bq - 1) continue;  // uniform branch
    attend_tile<T>(f, sm, K, V, q0, ki * f.bk, ki * f.bk, f.sk);
  }
  drain<T>(f, sm, O, q0, q0, f.sq);
}

size_t smem_bytes(int bq, int bk, int d) {
  return sizeof(float) * ((size_t)bq * d + (size_t)bk * (d + 1) +
                          (size_t)bk * d + (size_t)bq * (bk + 1) +
                          (size_t)bq * d + 3 * (size_t)bq);
}

bool shape_ok(const FlashArgs& f) {
  return f.bq >= 1 && f.bq <= BQ_MAX && f.bk >= 1 && f.bk <= BK_MAX &&
         f.d >= 1 && f.d <= D_MAX;
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t s,
                   Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, NT, smem, s>>>(args...);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_fwd_fused(const void* q, const void* k, const void* v,
                               void* o, const int* table, const int* qindex,
                               int num_q_blocks, int bh, int sq, int sk, int d,
                               int bq, int bk, int causal, float scale,
                               int dtype, void* stream) {
  FlashArgs f{q, k, v, o, sq, sk, d, bq, bk, causal, scale};
  if (!shape_ok(f)) return cudaErrorInvalidValue;
  dim3 grid(num_q_blocks, bh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(bq, bk, d);
  if (dtype == 1)
    return launch(flash_fused_kernel<__nv_bfloat16>, grid, smem, s, f, table,
                  qindex);
  if (dtype == 0)
    return launch(flash_fused_kernel<float>, grid, smem, s, f, table, qindex);
  return cudaErrorInvalidValue;
}

extern "C" int flash_fwd_dense(const void* q, const void* k, const void* v,
                               void* o, int bh, int sq, int sk, int d, int bq,
                               int bk, int causal, float scale, int dtype,
                               void* stream) {
  FlashArgs f{q, k, v, o, sq, sk, d, bq, bk, causal, scale};
  if (!shape_ok(f)) return cudaErrorInvalidValue;
  dim3 grid((sq + bq - 1) / bq, bh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(bq, bk, d);
  if (dtype == 1)
    return launch(flash_dense_kernel<__nv_bfloat16>, grid, smem, s, f);
  if (dtype == 0) return launch(flash_dense_kernel<float>, grid, smem, s, f);
  return cudaErrorInvalidValue;
}
