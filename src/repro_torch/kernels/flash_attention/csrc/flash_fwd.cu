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
//     into the owned rows [q0, q_end) only.  Given a non-null `lse`
//     ((BH, sq) fp32), the drain also writes lse = m + log(max(l, 1e-30))
//     for the owned rows: the residual the backward (flash_bwd.cu)
//     recomputes P from, as `return_lse=True` does in the reference;
//   * flash_fwd_dense <- build_flash_kernel (_flash_kernel): grid
//     (ceil(sq/bq), BH); every k-block is visited in order and those past
//     the causal diagonal (ki*bk > qi*bq + bq - 1) are skipped; the KV tail
//     is masked and V rows at or past sk are zero.
// Both entry points run one device routine per route that walks one
// q-block; they differ only in the list of K/V windows it walks.
//
// Numerics follow the reference exactly where it matters: masked scores are
// NEG_INF = -1e30 (not -inf, so a row whose first tiles are fully masked
// carries p = 1 until a real score washes it out through alpha instead of
// producing NaN); P is rounded to V's type before the PV product while l
// sums the fp32 p; the drain divides by max(l, 1e-30).  The causal
// diagonal is start-aligned (kpos <= qpos), which equals the end-aligned
// oracle only when sq == sk -- the model's only causal call.
//
// What bounds it on the H100 at the main-path shape (BH = 64 = batch 4 x 16
// heads, sq = sk = 256, d = 128, causal, bf16): 1.07 GFLOP of useful work
// against 16.8 MB of q/k/v/o, ~64 flop/byte, below the ~295 flop/byte ridge:
// the bound is bytes (5.0 us at 3.35 TB/s); at this size a q-block's
// serial walk over its 1-4 windows (load, QK^T, softmax, PV) and the launch
// set the time.  The routes (chosen per call in kernel.py, which counts
// them):
//   (A) bf16 operands TMA can read (16-byte aligned bases, rows of 2d bytes
//       a multiple of 16): one consumer warpgroup holds one 64-row q-block,
//       exactly wgmma's M, and a producer warp keeps a ring of STAGES K/V
//       windows in flight by TMA, completed on mbarriers; Q is loaded once.
//       The tensor maps are 3-D over (BH, s, d) with each head's own extent
//       s, so TMA zero-fills rows past a head's end: no window reads the
//       next head, and V rows past sk are zero.
//         S = Q K^T is the GEMM's "nt" product: Q and the K window arrive
//       as K-major panels of 32 columns in the 64-byte swizzle, and
//       m64n64k16 products sum them into 32 fp32 registers a thread.  The
//       mask, the scale and the online softmax run on those registers: a
//       thread holds rows 16 warp + lane/4 and +8, and a row's max and sum
//       are reduced over the 4 lanes of a quad.  P is rounded to bf16 and
//       written into a K-major, 64-byte-swizzled panel (double-buffered),
//       with the XOR the descriptor assumes applied in software.
//         O += P V is the GEMM's "nn" product: the V window arrives as
//       MN-major 64-column chunks of 32 key rows in the 128-byte swizzle,
//       and m64n{64,128}k16 products accumulate into the O registers,
//       rescaled by alpha first.  The drain stores only the owned rows.
//       About 97 KB of shared memory a block: two blocks share an SM.
//   (C) bf16 operands TMA cannot read, and fp32 operands (never TF32): the
//       simple design, fp32 math on CUDA cores from tiles staged in shared
//       memory, a 64 x 64 tile, 128 threads.
// The PTX building blocks are the dense GEMM's (gemm_sm90.cuh), the tensor
// map encoder is wgmma_tile.cuh's.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "../../gemm/csrc/gemm_sm90.cuh"
#include "../../gemm/csrc/wgmma_tile.cuh"

namespace {

constexpr int NT = 128;
constexpr int BQ_MAX = 64;
constexpr int BK_MAX = 64;
constexpr int D_MAX = 128;
constexpr float NEG_INF = -1e30f;

enum { ROUTE_A = 0, ROUTE_C = 1 };

struct FlashArgs {
  const void* q;  // (BH, sq, d)
  const void* k;  // (BH, sk, d)
  const void* v;  // (BH, sk, d)
  void* o;        // (BH, sq, d)
  float* lse;     // (BH, sq) or null: no LSE output
  int sq, sk, d, bq, bk, causal;
  float scale;
};

// ---------------------------------------------------------------------------
// Route C (and fp32): CUDA-core FMAs from tiles staged in shared memory.
// ---------------------------------------------------------------------------

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
// [o_lo, o_hi), and their log-sum-exp when L is not null.
template <typename T>
__device__ void drain(const FlashArgs& f, const Smem& sm, T* O, float* L,
                      int qs, int o_lo, int o_hi) {
  __syncthreads();
  for (int i = threadIdx.x; i < f.bq * f.d; i += NT) {
    const int r = i / f.d, c = i % f.d, qpos = qs + r;
    if (qpos >= o_lo && qpos < o_hi)
      O[(int64_t)qpos * f.d + c] = from_f<T>(sm.acc[i] / fmaxf(sm.l[r], 1e-30f));
  }
  if (L != nullptr) {
    for (int r = threadIdx.x; r < f.bq; r += NT) {
      const int qpos = qs + r;
      if (qpos >= o_lo && qpos < o_hi)
        L[qpos] = sm.m[r] + logf(fmaxf(sm.l[r], 1e-30f));
    }
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
  float* L = f.lse == nullptr ? nullptr : f.lse + bh * f.sq;
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
    if (row[7]) drain<T>(f, sm, O, L, qs, row[0], row[1]);
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
  drain<T>(f, sm, O, nullptr, q0, q0, f.sq);
}

size_t smem_bytes(int bq, int bk, int d) {
  return sizeof(float) * ((size_t)bq * d + (size_t)bk * (d + 1) +
                          (size_t)bk * d + (size_t)bq * (bk + 1) +
                          (size_t)bq * d + 3 * (size_t)bq);
}

// ---------------------------------------------------------------------------
// Route A: TMA-fed K/V ring, wgmma for QK^T and PV, softmax in registers.
// ---------------------------------------------------------------------------

constexpr int WG_THREADS = 128;                 // the consumer warpgroup
constexpr int TC_THREADS = WG_THREADS + 32;     // + the TMA producer warp
constexpr int STAGES = 2;                       // K/V windows in flight
// One TMA box: 64 rows of 64 bytes (32 bf16 columns of Q or K, K-major,
// 64-byte swizzle), or 32 key rows of 128 bytes (64 columns of V,
// MN-major, 128-byte swizzle).  Either is 4096 bytes on a 1024-byte
// boundary.
constexpr int BOX = 4096;
constexpr int Q_BYTES = D_MAX / 32 * BOX;       // Q: D_MAX / 32 K-major panels
constexpr int KV_BYTES = 2 * D_MAX / 32 * BOX;  // a stage: K's panels, then V's
constexpr int P_BYTES = BQ_MAX * BK_MAX * 2;    // P: two 32-key K-major panels
// Shared memory of a route-A block: 1024 bytes of alignment slack, Q, the
// ring, two P buffers, and the Q barrier with a full and an empty barrier
// a stage.
constexpr int TC_SMEM =
    1024 + Q_BYTES + STAGES * KV_BYTES + 2 * P_BYTES + 8 * (1 + 2 * STAGES);
static_assert(2 * TC_SMEM <= 232448, "two route-A blocks share an SM");

// One K/V window of a q-block's walk: its origin, the key columns it
// contributes, whether it opens or drains the carry, and the rows a drain
// stores.
struct Window {
  int ks, k_lo, k_hi, first, last, o_lo, o_hi;
};

// The fused kernel's windows: its q-block's run of tile-table rows.
struct FusedWalk {
  const int* table;
  int start, count;
  __device__ __forceinline__ int size() const { return count; }
  __device__ __forceinline__ Window at(int t) const {
    // A row: q0 q_end qs k0 k_end ks first last.
    const int* row = table + (int64_t)(start + t) * 8;
    return {row[5], row[3], row[4], row[6], row[7], row[0], row[1]};
  }
};

// The dense kernel's windows: k-blocks 0 .. n - 1, those past the causal
// diagonal (ki * bk > q0 + bq - 1) left out.
struct DenseWalk {
  int q0, bq, bk, sq, sk, n;
  __device__ __forceinline__ int size() const { return n; }
  __device__ __forceinline__ Window at(int t) const {
    return {t * bk, t * bk, sk, t == 0, t == n - 1, q0, min(q0 + bq, sq)};
  }
};

// One q-block: the window rows [qs, qs + 64) of head `bh` against the
// walk's K/V windows.  DN (64 or 128) is the head dim rounded up: Q and K
// columns past d, and V columns past d, arrive as zeros.
template <int DN, typename Walk>
__device__ __forceinline__ void attend(const FlashArgs& f, const Walk& w,
                                       int qs, int bh, const CUtensorMap* mq,
                                       const CUtensorMap* mk,
                                       const CUtensorMap* mv,
                                       unsigned char* smem) {
  using namespace sm90;
  constexpr int QP = DN / 32;  // 32-column panels of Q and K
  constexpr int VC = DN / 64;  // 64-column chunks of V
  const uint32_t base = smem_u32(smem);
  const uint32_t q_s = base, ring = base + Q_BYTES;
  const uint32_t p_s = ring + STAGES * KV_BYTES;
  const uint32_t bars = p_s + 2 * P_BYTES;  // q, full[s], empty[s]
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + STAGES + s); };
  const int n = w.size();
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= WG_THREADS) {
    // Producer: Q once, then each window's K and V into the next free
    // stage, up to STAGES windows ahead of the consumers.
    if (threadIdx.x == WG_THREADS) {
      mbar_expect_tx(bars, QP * BOX);
      for (int p = 0; p < QP; ++p)
        tma_load_3d(q_s + p * BOX, mq, bars, 32 * p, qs, bh);
      int s = 0;
      uint32_t phase = 0;
      for (int t = 0; t < n; ++t) {
        const int ks = w.at(t).ks;
        mbar_wait(empty(s), phase ^ 1);
        const uint32_t k = ring + s * KV_BYTES, v = k + KV_BYTES / 2;
        mbar_expect_tx(full(s), (QP + 2 * VC) * BOX);
        for (int p = 0; p < QP; ++p)
          tma_load_3d(k + p * BOX, mk, full(s), 32 * p, ks, bh);
        for (int h = 0; h < 2; ++h)  // 32-key halves of the window
          for (int c = 0; c < VC; ++c)
            tma_load_3d(v + h * 2 * BOX + c * BOX, mv, full(s), 64 * c,
                        ks + 32 * h, bh);
        if (++s == STAGES) { s = 0; phase ^= 1; }
      }
    }
    return;
  }

  // Consumers.  wgmma's accumulator layout: register 4 j + 2 i + c holds
  // row r0 + 8 i, column 8 j + c0 + c.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
  const int64_t head = (int64_t)bh * f.sq;
  __nv_bfloat16* O = reinterpret_cast<__nv_bfloat16*>(f.o) + head * f.d;
  float* L = f.lse == nullptr ? nullptr : f.lse + head;
  float o[DN / 2], s[32], m[2], l[2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) o[i] = 0.f;
  m[0] = m[1] = NEG_INF;
  l[0] = l[1] = 0.f;
  mbar_wait(bars, 0);
  int st = 0;
  uint32_t phase = 0;
  for (int t = 0; t < n; ++t) {
    const Window win = w.at(t);
    if (win.first) {
#pragma unroll
      for (int i = 0; i < DN / 2; ++i) o[i] = 0.f;
      m[0] = m[1] = NEG_INF;
      l[0] = l[1] = 0.f;
    }
    mbar_wait(full(st), phase);
    __syncwarp();  // wgmma is .aligned: the warp reconverges first
    const uint32_t k = ring + st * KV_BYTES, v = k + KV_BYTES / 2;

    // S = Q K^T: QP panels of two k-steps each.
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < QP; ++p)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        wgmma_n64<0, 0>(s, desc_k64(q_s + p * BOX + 32 * h),
                        desc_k64(k + p * BOX + 32 * h));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // Scale and mask, then the row maxima.  A thread's columns are c0 +
    // cc, cc = 8 j + c (kpos = kb + cc): a score is valid where lo <= cc <
    // hi[i], the window's key range cut to its bk columns and, causal, to
    // kpos <= qpos.  Columns at or past bk (cc >= width) are not part of
    // the window: they take no part in the max and get p = 0.
    const int kb = win.ks + c0, width = f.bk - c0, lo = win.k_lo - kb;
    int hi[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int h = min(win.k_hi, win.ks + f.bk);
      if (f.causal) h = min(h, qs + r0 + 8 * i + 1);
      hi[i] = h - kb;
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int cc = 8 * j + c;
          float& x = s[4 * j + 2 * i + c];
          x = cc >= lo && cc < hi[i] ? x * f.scale : NEG_INF;
          if (cc < width) mx[i] = fmaxf(mx[i], x);
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }

    // p = exp(s - m_new): summed in fp32 into l, rounded to bf16 into this
    // window's P buffer, K-major rows of 64 bytes with the 16-byte chunk
    // index XORed with bits 1-2 of the row (the 64-byte swizzle).
    unsigned char* pbuf = smem + (p_s - base) + (t & 1) * P_BYTES;
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + 8 * i;
        const float p0 =
            8 * j < width ? expf(s[4 * j + 2 * i] - mx[i]) : 0.f;
        const float p1 =
            8 * j + 1 < width ? expf(s[4 * j + 2 * i + 1] - mx[i]) : 0.f;
        sum[i] += p0 + p1;
        const int off = (j / 4) * BOX + r * 64 +
                        (((j % 4) ^ ((r >> 1) & 3)) << 4) + c0 * 2;
        *reinterpret_cast<__nv_bfloat162*>(pbuf + off) =
            __floats2bfloat162_rn(p0, p1);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      alpha[i] = expf(m[i] - mx[i]);
      l[i] = l[i] * alpha[i] + sum[i];
      m[i] = mx[i];
    }
    fence_proxy_async();      // P's generic writes, visible to wgmma
    bar_sync(1, WG_THREADS);  // every row of P is written

    // O = alpha O + P V: four k-steps of 16 keys.
#pragma unroll
    for (int j = 0; j < DN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        o[4 * j + 2 * i] *= alpha[i];
        o[4 * j + 2 * i + 1] *= alpha[i];
      }
    const uint32_t pa = p_s + (t & 1) * P_BYTES;
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = desc_k64(pa + (kk / 2) * BOX + (kk % 2) * 32);
      const uint64_t db = desc_mn128(v + (kk / 2) * 2 * BOX + (kk % 2) * 2048);
      if constexpr (DN == 128)
        wgmma_n128<0, 1>(o, da, db);
      else
        wgmma_n64<0, 1>(o, da, db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));  // this warp is done with K, V
    if (++st == STAGES) { st = 0; phase ^= 1; }

    if (win.last) {
      // The drain: owned rows only (a ragged table's windows overlap the
      // neighbouring q-block's rows), pairs of columns below d.
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qpos = qs + r0 + 8 * i;
        if (qpos < win.o_lo || qpos >= win.o_hi) continue;
        const float den = fmaxf(l[i], 1e-30f);
        __nv_bfloat16* orow = O + (int64_t)qpos * f.d;
#pragma unroll
        for (int j = 0; j < DN / 8; ++j) {
          const int col = 8 * j + c0;
          if (col < f.d)
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(o[4 * j + 2 * i] / den,
                                      o[4 * j + 2 * i + 1] / den);
        }
        if (L != nullptr && lane % 4 == 0) L[qpos] = m[i] + logf(den);
      }
    }
  }
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* raw) {
  const uint32_t a = sm90::smem_u32(raw);
  return raw + (((a + 1023) & ~1023u) - a);
}

template <int DN>
__global__ void __launch_bounds__(TC_THREADS, 2)
flash_fused_wgmma(const __grid_constant__ CUtensorMap mq,
                  const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv,
                  const __grid_constant__ FlashArgs f,
                  const int* __restrict__ table,
                  const int* __restrict__ qindex) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int start = qindex[2 * blockIdx.x], count = qindex[2 * blockIdx.x + 1];
  const FusedWalk w{table, start, count};
  attend<DN>(f, w, table[start * 8 + 2], blockIdx.y, &mq, &mk, &mv,
             align1024(smem_raw));
}

template <int DN>
__global__ void __launch_bounds__(TC_THREADS, 2)
flash_dense_wgmma(const __grid_constant__ CUtensorMap mq,
                  const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv,
                  const __grid_constant__ FlashArgs f) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int q0 = blockIdx.x * f.bq;
  const int k_steps = (f.sk + f.bk - 1) / f.bk;
  const int n = f.causal ? min(k_steps, (q0 + f.bq - 1) / f.bk + 1) : k_steps;
  const DenseWalk w{q0, f.bq, f.bk, f.sq, f.sk, n};
  attend<DN>(f, w, q0, blockIdx.y, &mq, &mk, &mv, align1024(smem_raw));
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

bool shape_ok(const FlashArgs& f) {
  return f.bq >= 1 && f.bq <= BQ_MAX && f.bk >= 1 && f.bk <= BK_MAX &&
         f.d >= 1 && f.d <= D_MAX;
}

// Raises a kernel's dynamic shared-memory limit to `bytes`, once per
// kernel, so that a launch inside a CUDA-graph capture makes no attribute
// call.
template <auto kernel>
cudaError_t allow_smem(int bytes) {
  static const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return e;
}

template <auto kernel, typename... Args>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t s, Args... args) {
  cudaError_t e = allow_smem<kernel>((int)smem_bytes(BQ_MAX, BK_MAX, D_MAX));
  if (e != cudaSuccess) return e;
  kernel<<<grid, NT, smem, s>>>(args...);
  return cudaGetLastError();
}

// Route A's tensor maps: Q and K in boxes of 32 columns x 64 rows (K-major,
// 64-byte swizzle), V in boxes of 64 columns x 32 rows (MN-major, 128-byte
// swizzle), each 3-D over (BH, s, d) with the head's own extent.
bool make_maps(const FlashArgs& f, int bh, CUtensorMap* mq, CUtensorMap* mk,
               CUtensorMap* mv) {
  return wgt::make_map(mq, f.q, f.d, f.sq, bh, 32, 64,
                       CU_TENSOR_MAP_SWIZZLE_64B) &&
         wgt::make_map(mk, f.k, f.d, f.sk, bh, 32, 64,
                       CU_TENSOR_MAP_SWIZZLE_64B) &&
         wgt::make_map(mv, f.v, f.d, f.sk, bh, 64, 32,
                       CU_TENSOR_MAP_SWIZZLE_128B);
}

template <auto kernel, typename... Args>
cudaError_t launch_wgmma(const FlashArgs& f, dim3 grid, cudaStream_t s,
                         Args... args) {
  CUtensorMap mq{}, mk{}, mv{};
  if (!make_maps(f, grid.y, &mq, &mk, &mv)) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem<kernel>(TC_SMEM);
  if (e != cudaSuccess) return e;
  kernel<<<grid, TC_THREADS, TC_SMEM, s>>>(mq, mk, mv, f, args...);
  return cudaGetLastError();
}

}  // namespace

// route: ROUTE_A (TMA ring + wgmma) or ROUTE_C (CUDA cores) for bf16,
// ignored for fp32 (CUDA cores).
extern "C" int flash_fwd_fused(const void* q, const void* k, const void* v,
                               void* o, float* lse, const int* table,
                               const int* qindex, int num_q_blocks, int bh,
                               int sq, int sk, int d, int bq, int bk,
                               int causal, float scale, int dtype, int route,
                               void* stream) {
  FlashArgs f{q, k, v, o, lse, sq, sk, d, bq, bk, causal, scale};
  if (!shape_ok(f)) return cudaErrorInvalidValue;
  dim3 grid(num_q_blocks, bh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && route == ROUTE_A)
    return d <= 64
               ? launch_wgmma<flash_fused_wgmma<64>>(f, grid, s, table, qindex)
               : launch_wgmma<flash_fused_wgmma<128>>(f, grid, s, table,
                                                      qindex);
  const size_t smem = smem_bytes(bq, bk, d);
  if (dtype == 1 && route == ROUTE_C)
    return launch<flash_fused_kernel<__nv_bfloat16>>(grid, smem, s, f, table,
                                                     qindex);
  if (dtype == 0)
    return launch<flash_fused_kernel<float>>(grid, smem, s, f, table, qindex);
  return cudaErrorInvalidValue;
}

extern "C" int flash_fwd_dense(const void* q, const void* k, const void* v,
                               void* o, int bh, int sq, int sk, int d, int bq,
                               int bk, int causal, float scale, int dtype,
                               int route, void* stream) {
  FlashArgs f{q, k, v, o, nullptr, sq, sk, d, bq, bk, causal, scale};
  if (!shape_ok(f)) return cudaErrorInvalidValue;
  dim3 grid((sq + bq - 1) / bq, bh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && route == ROUTE_A)
    return d <= 64 ? launch_wgmma<flash_dense_wgmma<64>>(f, grid, s)
                   : launch_wgmma<flash_dense_wgmma<128>>(f, grid, s);
  const size_t smem = smem_bytes(bq, bk, d);
  if (dtype == 1 && route == ROUTE_C)
    return launch<flash_dense_kernel<__nv_bfloat16>>(grid, smem, s, f);
  if (dtype == 0) return launch<flash_dense_kernel<float>>(grid, smem, s, f);
  return cudaErrorInvalidValue;
}
