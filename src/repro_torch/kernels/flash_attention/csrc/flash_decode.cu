// Paged decode attention for Hopper (sm_90a): one continuous-batching
// decode step, o[s] = softmax(q[s] K_s^T * hd^-0.5) V_s, where slot s's
// keys and values live in pages of a shared pool that its block table maps.
//
// Replaces the reference package's TPU kernel
// src/repro/kernels/flash_attention/kernel.py::build_decode_flash_kernel
// (_decode_flash_kernel): there a sequential grid walks the runtime
// DecodeTileSchedule rows (seq, page, k_len, first, last), one pool page per
// grid step, carrying m / l / acc in VMEM scratch.  Here the sequential walk
// becomes a loop inside a thread block: grid (S, hkv), one block per
// (slot, KV head), which walks its slot's rows [bstart[s], bstart[s + 1])
// of the same table.  Per row it stages the page's K and V rows of its KV
// head in shared memory, scores the GQA group's h / hkv query heads against
// them in fp32, and runs a per-head online softmax: the carry resets at
// `first` and drains into the owned output rows at `last`.  The table and
// the offsets are device data that the runtime rewrites every step, so a
// churning batch never rebuilds anything.
//
// Numerics follow the reference: dead page slots (k_len <= column) get the
// score NEG_INF = -1e30 (not -inf) and their V rows are *selected* to 0,
// never multiplied (stale pages may hold NaN), so an empty slot's one dummy
// row (k_len = 0: every p = exp(0) = 1) drains exact zeros through
// acc / max(l, 1e-30); scores are scaled in fp32; P is rounded to V's type
// before the PV product.
//
// KV-int8 pools (the reference's kv_quant=True, _decode_flash_kernel's
// quant branch): the pools hold int8 values with per-token f32 scales,
// (pages, P) arrays k_scale / v_scale on the same page walk.  The values
// widen exactly; the scales are separable by page position, so the K
// scale multiplies a score column after the hd^-0.5 scaling
// (q . (k s) = (q . k) s), and the V scale folds into P before it is
// rounded to q's type for the PV product (sum_j p_j (v_j s_j) =
// sum_j (p_j s_j) v_j); the softmax sum l takes the unscaled p.  A dead
// slot's scales are selected to 0 like its values, never multiplied in.
//
// What bounds it on the H100 at the serving shape (8 slots, 16 query / 8 KV
// heads of 128, page 16, bf16, a few hundred positions a slot): about 4 h hd
// flops per cached position against 2 hkv hd x 2 bytes of K/V, ~4 flop/byte,
// far below the ~295 flop/byte ridge: the bound is bytes (the live pages
// once).  At that size the launch and each block's serial page walk
// dominate.  The simple design: fp32 math on CUDA cores from one page staged
// in shared memory at a time, 128 threads.  Splitting a long walk over
// several blocks (flash-decoding), TMA page loads and tensor-core products
// are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int NT = 128;
constexpr int PAGE_MAX = 64;
constexpr int D_MAX = 128;
constexpr int GROUP_MAX = 64;
constexpr float NEG_INF = -1e30f;

struct DecodeArgs {
  const void* q;       // (S, h, hd)
  const void* k;       // (pages, P, hkv, hd)
  const void* v;       // (pages, P, hkv, hd)
  void* o;             // (S, h, hd)
  const int* table;    // (max_tiles, 5): seq page k_len first last
  const int* bstart;   // (S + 1,): slot s's rows [bstart[s], bstart[s+1])
  const float* ks;     // (pages, P) K scales of int8 pools, else null
  const float* vs;     // (pages, P) V scales of int8 pools, else null
  int h, hkv, hd, page_size;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(signed char x) {
  return static_cast<float>(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared-memory carve-up (floats): the group's q rows, one page of k
// (padded rows) and v, the scores (padded rows), the output accumulator,
// the per-head m / l / alpha and the page's K and V scales (int8 pools).
struct Smem {
  float *q, *k, *v, *s, *acc, *m, *l, *alpha, *ks, *vs;
  __device__ Smem(float* base, int rep, int page, int d) {
    q = base;
    k = q + rep * d;
    v = k + page * (d + 1);
    s = v + page * d;
    acc = s + rep * (page + 1);
    m = acc + rep * d;
    l = m + rep;
    alpha = l + rep;
    ks = alpha + rep;
    vs = ks + page;
  }
};

// T: q's (and the output's) type; TKV: the pools' (T, or signed char for
// KV-int8 pools with their scales).
template <typename T, typename TKV>
__global__ void __launch_bounds__(NT) flash_decode_kernel(DecodeArgs f) {
  constexpr bool QUANT = std::is_same<TKV, signed char>::value;
  extern __shared__ float smem[];
  const int rep = f.h / f.hkv, d = f.hd, P = f.page_size;
  const Smem sm(smem, rep, P, d);
  const int slot = blockIdx.x, g = blockIdx.y;
  const int64_t head0 = (int64_t)slot * f.h + (int64_t)g * rep;
  const T* Q = reinterpret_cast<const T*>(f.q) + head0 * d;
  const TKV* K = reinterpret_cast<const TKV*>(f.k);
  const TKV* V = reinterpret_cast<const TKV*>(f.v);
  T* O = reinterpret_cast<T*>(f.o) + head0 * d;
  for (int i = threadIdx.x; i < rep * d; i += NT) sm.q[i] = to_f(Q[i]);

  const int start = f.bstart[slot], end = f.bstart[slot + 1];
  for (int t = start; t < end; ++t) {
    const int* row = f.table + (int64_t)t * 5;
    const int64_t page = row[1];
    const int k_len = row[2];
    __syncthreads();  // the previous row's readers of k / v / s are done
    if (row[3]) {     // first: reset the carry
      for (int i = threadIdx.x; i < rep * d; i += NT) sm.acc[i] = 0.f;
      for (int r = threadIdx.x; r < rep; r += NT) {
        sm.m[r] = NEG_INF;
        sm.l[r] = 0.f;
      }
    }
    // The page's rows of this KV head; dead slots are selected to 0 and
    // never read.
    for (int i = threadIdx.x; i < P * d; i += NT) {
      const int j = i / d, c = i % d;
      const int64_t at = ((page * P + j) * f.hkv + g) * d + c;
      const bool live = j < k_len;
      sm.k[j * (d + 1) + c] = live ? to_f(K[at]) : 0.f;
      sm.v[j * d + c] = live ? to_f(V[at]) : 0.f;
    }
    if (QUANT) {
      for (int j = threadIdx.x; j < P; j += NT) {
        const bool live = j < k_len;
        sm.ks[j] = live ? f.ks[page * P + j] : 0.f;
        sm.vs[j] = live ? f.vs[page * P + j] : 0.f;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rep * P; i += NT) {
      const int r = i / P, j = i % P;
      const float* qr = sm.q + r * d;
      const float* kr = sm.k + j * (d + 1);
      float dot = 0.f;
      for (int c = 0; c < d; ++c) dot = fmaf(qr[c], kr[c], dot);
      float sc = dot * f.scale;
      if (QUANT) sc = sc * sm.ks[j];
      sm.s[r * (P + 1) + j] = j < k_len ? sc : NEG_INF;
    }
    __syncthreads();
    for (int r = threadIdx.x; r < rep; r += NT) {
      float* sr = sm.s + r * (P + 1);
      const float m_prev = sm.m[r];
      float m_new = m_prev;
      for (int j = 0; j < P; ++j) m_new = fmaxf(m_new, sr[j]);
      float sum = 0.f;
      for (int j = 0; j < P; ++j) {
        const float p = expf(sr[j] - m_new);
        sum += p;
        // P (times the V scale of an int8 pool) in q's type for the PV
        // product
        sr[j] = to_f(from_f<T>(QUANT ? p * sm.vs[j] : p));
      }
      const float alpha = expf(m_prev - m_new);
      sm.l[r] = sm.l[r] * alpha + sum;
      sm.m[r] = m_new;
      sm.alpha[r] = alpha;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rep * d; i += NT) {
      const int r = i / d, c = i % d;
      const float* pr = sm.s + r * (P + 1);
      float pv = 0.f;
      for (int j = 0; j < P; ++j) pv = fmaf(pr[j], sm.v[j * d + c], pv);
      sm.acc[i] = sm.acc[i] * sm.alpha[r] + pv;
    }
    if (row[4]) {  // last: drain into the group's output rows
      __syncthreads();
      for (int i = threadIdx.x; i < rep * d; i += NT)
        O[i] = from_f<T>(sm.acc[i] / fmaxf(sm.l[i / d], 1e-30f));
    }
  }
}

size_t smem_bytes(int rep, int page, int d) {
  return sizeof(float) * (2 * (size_t)rep * d + (size_t)page * (d + 1) +
                          (size_t)page * d + (size_t)rep * (page + 1) +
                          3 * (size_t)rep + 2 * (size_t)page);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t s,
                   const DecodeArgs& f) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, NT, smem, s>>>(f);
  return cudaGetLastError();
}

}  // namespace

// dtype: q's (0 fp32, 1 bf16); the pools are q's type when k_scale and
// v_scale are null, int8 when both are given.
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            void* o, const int* table, const int* bstart,
                            const float* k_scale, const float* v_scale,
                            int num_seqs, int h, int hkv, int hd,
                            int page_size, float scale, int dtype,
                            void* stream) {
  if (num_seqs < 1 || hkv < 1 || hkv > 65535 || h % hkv != 0 ||
      h / hkv > GROUP_MAX || hd < 1 || hd > D_MAX || page_size < 1 ||
      page_size > PAGE_MAX || (k_scale == nullptr) != (v_scale == nullptr))
    return cudaErrorInvalidValue;
  DecodeArgs f{q,       k,       v, o,   table, bstart,    k_scale,
               v_scale, h,       hkv, hd, page_size, scale};
  dim3 grid(num_seqs, hkv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(h / hkv, page_size, hd);
  const bool quant = k_scale != nullptr;
  if (dtype == 1)
    return quant ? launch(flash_decode_kernel<__nv_bfloat16, signed char>,
                          grid, smem, s, f)
                 : launch(flash_decode_kernel<__nv_bfloat16, __nv_bfloat16>,
                          grid, smem, s, f);
  if (dtype == 0)
    return quant ? launch(flash_decode_kernel<float, signed char>, grid, smem,
                          s, f)
                 : launch(flash_decode_kernel<float, float>, grid, smem, s, f);
  return cudaErrorInvalidValue;
}
