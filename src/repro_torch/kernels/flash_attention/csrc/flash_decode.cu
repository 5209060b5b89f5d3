// Paged decode attention for Hopper (sm_90a): one continuous-batching
// decode step, o[s] = softmax(q[s] K_s^T * hd^-0.5) V_s, where slot s's
// keys and values live in pages of a shared pool that its block table maps.
//
// Replaces the reference package's TPU kernel
// src/repro/kernels/flash_attention/kernel.py::build_decode_flash_kernel
// (_decode_flash_kernel): there a sequential grid walks the runtime
// DecodeTileSchedule rows (seq, page, k_len, first, last), one pool page per
// grid step, carrying m / l / acc in VMEM scratch.  Here slot s's rows are
// [bstart[s], bstart[s + 1]) of the same table, in block-table order; the
// table and the offsets are device data that the runtime rewrites every
// step, so a churning batch never rebuilds anything.
//
// Numerics follow the reference: dead page slots (k_len <= column) get the
// score NEG_INF = -1e30 (not -inf) and their V rows are *selected* to 0,
// never multiplied (stale pages may hold NaN), so an empty slot's one dummy
// row (k_len = 0: every p = exp(0) = 1) drains exact zeros through
// acc / max(l, 1e-30); scores are scaled in fp32; P = exp(s - m_t) is
// rounded to q's type before the PV product, where m_t is the slot's
// running max over its pages 0..t in table order.
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
// heads of 128, page 16, a few hundred positions a slot): about 4 h hd
// flops per cached position against 2 hkv hd x 2 bytes of K/V (bf16), ~4
// flop/byte, far below the ~295 flop/byte ridge: the bound is bytes, the
// live pages read once, under a microsecond.  What a call costs in practice
// is latency: the table read, the page loads and the longest slot's walk.
//
// Route A (bf16 q over bf16 or int8 pools, GQA groups up to A_GROUP_MAX,
// pages up to A_PAGE_MAX rows, head dims 64 and 128):
//   * A thread-block cluster of C blocks a (slot, KV head); kernel.py picks
//     C from the slots x KV heads and the card's SMs (decode_cluster).
//     Rank r takes the contiguous chunk [lo, hi) of its slot's rows
//     (lo = start + r n / C), and the block's W warps take the chunk's
//     pages in parallel (warp w: pages w, w + W, ...): W = 16 for GQA
//     groups of up to 2 (a page a warp at the serving shape's longest
//     chunk), 8 for larger groups, whose registers hold more heads.
//   * Page loads are asynchronous: one TMA load a page for K and one for V,
//     from 3-D tensor maps (hd, hkv, pages P) over the pools with a box
//     (hd, 1, P) -- P rows of one KV head, hkv hd elements apart -- and the
//     int8 pools' (P,) scales by a bulk copy on the same mbarrier.  A chunk
//     that fits the block's ring (the main path's) is requested whole up
//     front, so every page of it is in flight at once; a longer one streams
//     through the ring in rounds.
//   * The reference rounds P against the running max m_t, which a split
//     walk does not know up front.  So each block first scores its chunk
//     (scores and page maxima kept in shared memory), then the cluster
//     exchanges the chunk maxima through distributed shared memory: rank r
//     starts its running max at the lower ranks' maximum, every page's m_t
//     is the sequential walk's, and P rounds at the same place.  Each page
//     adds exp(m_t - m_T) (bf16(P) V) to acc and exp(m_t - m_T) sum(p) to
//     l, against the slot's final max m_T (the sequential walk's alpha
//     chain, up to fp32 rounding); warps combine in shared memory, blocks
//     into rank 0 over distributed shared memory, in rank order, and rank
//     0 drains acc / max(l, 1e-30).  One launch a call.
//   * Math on CUDA cores, not tensor cores: at GQA group 2 a 64-row wgmma
//     tile would use 2 of its rows, and at ~4 flop/byte the bytes bound
//     the call anyway.  A lane holds 8 elements (16 bytes of bf16) of a
//     row, hd / 8 lanes a row (the head dim is a template parameter), q
//     stays in fp32 registers; a score is per-lane partial dots summed by
//     a reduce-scatter over the row's lanes, and each (row, head) takes
//     its exp and its rounding once, in one lane, before the PV product
//     reads it back as a weight.  No __syncthreads inside a page.
//   * TMA rather than cp.async: the host encodes the two tensor maps at
//     each launch, as flash_fwd.cu does its three, and the wrapper's
//     host-timed cost (PERF.md) includes them.
// Route B (fp32 q, larger groups or pages, other head dims, operands TMA
// cannot read): one 128-thread block per (slot, KV head) walks the slot's
// rows in series, staging one page in shared memory at a time, a per-head
// online softmax whose carry resets at `first` and drains at `last`.
// kernel.py picks the route (choose_decode_route); the entry refuses a
// route-A call outside route A's limits, so nothing falls back.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "../../gemm/csrc/gemm_sm90.cuh"
#include "../../gemm/csrc/wgmma_tile.cuh"

namespace {

// Route B's limits (H100_SXM.decode_max_*, which plan_flash_decode checks).
constexpr int NT = 128;
constexpr int PAGE_MAX = 64;
constexpr int D_MAX = 128;
constexpr int GROUP_MAX = 64;
constexpr float NEG_INF = -1e30f;

constexpr int ROUTE_A = 0;
constexpr int ROUTE_B = 1;

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

// ---------------------------------------------------------------------------
// Route B: one block per (slot, KV head), a page at a time.
// ---------------------------------------------------------------------------

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


// ---------------------------------------------------------------------------
// Route A: a cluster of blocks a (slot, KV head), TMA page loads, the walk
// split over ranks and warps.
// ---------------------------------------------------------------------------

// Warps of a route-A block: 16 for GQA groups of up to 2 (the register
// budget of 512 threads), 8 for larger groups.
__host__ __device__ constexpr int warps_a(int group) {
  return group <= 2 ? 16 : 8;
}
constexpr int A_GROUP_MAX = 8;   // H100_SXM.decode_a_max_group
constexpr int A_PAGE_MAX = 64;   // H100_SXM.decode_a_max_page (rows, P % 4 == 0)
constexpr int A_RING_MAX = 32;   // pages a block stages at once (a phase bit each)
constexpr int A_RING_BYTES = 128 * 1024;  // the staged K and V pages
constexpr int A_SMEM_LIMIT = 232448;      // H100_SXM.vmem_bytes
constexpr int MAX_CLUSTER = 8;   // the portable cluster size

// Route A's head dims (H100_SXM.decode_a_head_dims): 8 elements a lane,
// hd / 8 lanes a row dividing the warp and at least A_GROUP_MAX (a
// score's reduce-scatter), and rows of 16-byte multiples in both pool
// types (the tensor maps' row stride hkv hd bytes too).
__host__ __device__ constexpr bool head_dim_a(int hd) {
  return hd == 64 || hd == 128;
}

__host__ __device__ constexpr int align_up(int x, int a) {
  return (x + a - 1) / a * a;
}

// Route A's dynamic shared memory, in bytes from a 128-byte-aligned base:
// the ring's K and V pages, their (P,) scales (int8 pools), the round's
// scores and page maxima, the warps' partial acc and l, the chunk / prefix
// / final maxima, the block's acc and l (read by rank 0 over DSMEM), the
// ring's k_len, and a K and a V mbarrier a ring slot.
struct LayoutA {
  int page, k, v, ks, vs, sc, pm, wred, stat, cacc, klen, bar, total;
  __host__ __device__ LayoutA(int ring, int rep, int P, int hd, int isz,
                              int warps) {
    page = align_up(P * hd * isz, 128);
    k = 0;
    v = k + ring * page;
    ks = v + ring * page;
    vs = ks + ring * P * 4;
    sc = vs + ring * P * 4;
    pm = sc + ring * rep * P * 4;
    wred = pm + ring * rep * 4;
    stat = wred + warps * rep * (hd + 1) * 4;
    cacc = stat + 3 * rep * 4;
    klen = cacc + rep * (hd + 1) * 4;
    bar = align_up(klen + ring * 4, 8);
    total = bar + 2 * ring * 8;
  }
};

struct DecodeArgsA {
  const void* q;       // (S, h, hd) bf16
  void* o;             // (S, h, hd) bf16
  const int* table;    // (max_tiles, 5): seq page k_len first last
  const int* bstart;   // (S + 1,)
  const float* ks;     // (pages, P) K scales of int8 pools, else null
  const float* vs;     // (pages, P) V scales of int8 pools, else null
  int h, hkv, hd, page_size, ring, cluster;
  float scale;
};

// 8 consecutive elements (16 bytes of bf16, 8 of int8) into fp32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h2[e]);
    x[2 * e] = f.x;
    x[2 * e + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const signed char* p, float (&x)[8]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const signed char* c = reinterpret_cast<const signed char*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) x[e] = static_cast<float>(c[e]);
}

__device__ __forceinline__ float dot8(const float (&a)[8],
                                      const float (&b)[8]) {
  float d = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) d = fmaf(a[e], b[e], d);
  return d;
}

// A contiguous copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Flip the phase bits of ring slots [0, count): each was armed once more.
__device__ __forceinline__ void flip(uint32_t& phases, int count) {
  phases ^= count >= 32 ? 0xffffffffu : (1u << count) - 1u;
}

// TKV: the pools' type (bf16, or signed char for KV-int8 pools); R: the
// GQA group's register capacity (the group is at most R query heads); HD:
// the head dim; W: the block's warps (warps_a(R)).
template <typename TKV, int R, int HD, int W>
__global__ void __launch_bounds__(32 * W, 1)
flash_decode_split(const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv,
                   const __grid_constant__ DecodeArgsA f) {
  constexpr bool QUANT = std::is_same<TKV, signed char>::value;
  constexpr uint32_t FULL = 0xffffffffu;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  unsigned char* base = smem_raw + (((raw + 127) & ~127u) - raw);
  const uint32_t sbase = sm90::smem_u32(base);
  constexpr int hd = HD, THREADS = 32 * W;
  constexpr int V = HD / 8;     // lanes a row
  constexpr int RPW = 32 / V;   // rows a warp covers at once
  const int rep = f.h / f.hkv, P = f.page_size, ring = f.ring;
  const LayoutA lay(ring, rep, P, hd, (int)sizeof(TKV), W);
  float* ksm = reinterpret_cast<float*>(base + lay.ks);
  float* vsm = reinterpret_cast<float*>(base + lay.vs);
  float* sc = reinterpret_cast<float*>(base + lay.sc);    // (ring, rep, P)
  float* pm = reinterpret_cast<float*>(base + lay.pm);    // (ring, rep)
  float* wred = reinterpret_cast<float*>(base + lay.wred);
  float* stat = reinterpret_cast<float*>(base + lay.stat);
  float* cacc = reinterpret_cast<float*>(base + lay.cacc);  // (rep, hd + 1)
  int* klen = reinterpret_cast<int*>(base + lay.klen);      // (ring,)
  const uint32_t kbar = sbase + lay.bar, vbar = kbar + 8 * ring;

  const int C = f.cluster;
  const int slot = blockIdx.x / C, g = blockIdx.y;
  const int rank = C > 1 ? (int)sm90::cluster_rank() : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = (lane % V) * 8;
  const int passes = (P + RPW - 1) / RPW;

  // This rank's contiguous chunk of the slot's rows (kernel.py's
  // decode_chunk); a rank may get none and still joins every barrier.
  const int start = f.bstart[slot], n = f.bstart[slot + 1] - start;
  const int lo = start + rank * n / C;
  const int cnt = start + (rank + 1) * n / C - lo;
  const bool resident = cnt <= ring;
  const int rounds = (cnt + ring - 1) / ring;
  const int* rows = f.table + (int64_t)lo * 5;

  if (threadIdx.x == 0) {
    for (int i = 0; i < ring; ++i) {
      sm90::mbar_init(kbar + 8 * i, 1);
      sm90::mbar_init(vbar + 8 * i, 1);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  // Warp 0 requests pages [first, first + count) of the chunk into ring
  // slots [0, count), a lane a page: K (and its scales) on the slot's K
  // barrier, V (and its scales) on its V barrier.  The page's k_len goes
  // to shared memory before the barrier's arrival, which releases it to
  // the barrier's waiters.
  const uint32_t kv_bytes = (uint32_t)(P * hd * sizeof(TKV)) +
                            (QUANT ? (uint32_t)P * 4u : 0u);
  const CUtensorMap* kmap = &mk;
  const CUtensorMap* vmap = &mv;
  auto request = [&](int first, int count, bool with_k, bool with_v) {
    if (warp != 0) return;
    sm90::fence_proxy_async();
    for (int i = lane; i < count; i += 32) {
      const int page = rows[(int64_t)(first + i) * 5 + 1];
      klen[i] = rows[(int64_t)(first + i) * 5 + 2];
      if (with_k) {
        sm90::mbar_expect_tx(kbar + 8 * i, kv_bytes);
        sm90::tma_load_3d(sbase + lay.k + i * lay.page, kmap, kbar + 8 * i,
                          0, g, page * P);
        if (QUANT)
          bulk_load(sbase + lay.ks + i * P * 4, f.ks + (int64_t)page * P,
                    P * 4, kbar + 8 * i);
      }
      if (with_v) {
        sm90::mbar_expect_tx(vbar + 8 * i, kv_bytes);
        sm90::tma_load_3d(sbase + lay.v + i * lay.page, vmap, vbar + 8 * i,
                          0, g, page * P);
        if (QUANT)
          bulk_load(sbase + lay.vs + i * P * 4, f.vs + (int64_t)page * P,
                    P * 4, vbar + 8 * i);
      }
    }
  };

  // The group's q slice of this lane in fp32 registers.
  float qr[R][8];
  const __nv_bfloat16* Q = reinterpret_cast<const __nv_bfloat16*>(f.q) +
                           ((int64_t)slot * f.h + (int64_t)g * rep) * hd;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < rep) {
      load8(Q + r * hd + col, qr[r]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[r][e] = 0.f;
    }
  }

  // One staged page's scores into sc (dead columns NEG_INF) and its
  // per-head maxima into pm and `pmax` (every lane).  A lane's partial
  // dots cover 8 columns of one row a pass; a lane gathers G = V / R
  // passes x R heads of them, and a reduce-scatter over the row's V lanes
  // leaves lane u the full score of pass u / R, head u % R: V - 1
  // shuffles for V scores instead of V log2(V).
  auto score_page = [&](int i, int k_len, float (&pmax)[R]) {
    const TKV* kp = reinterpret_cast<const TKV*>(base + lay.k + i * lay.page);
#pragma unroll
    for (int r = 0; r < R; ++r) pmax[r] = NEG_INF;
    static_assert(V >= R, "a row's lanes hold at least the group");
    constexpr int G = V / R;
    const int u = lane % V;
    float mine = NEG_INF;  // the max of this lane's scores (head u % R)
    for (int g0 = 0; g0 < passes; g0 += G) {
      float part[V];
#pragma unroll
      for (int gp = 0; gp < G; ++gp) {
        const int j = (g0 + gp) * RPW + lane / V;  // zeros past P
        float kx[8];
        if (j < P) {
          load8(kp + j * hd + col, kx);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) kx[e] = 0.f;
        }
#pragma unroll
        for (int r = 0; r < R; ++r) part[gp * R + r] = dot8(qr[r], kx);
      }
#pragma unroll
      for (int n = V; n > 1; n >>= 1) {
        const bool up = lane & (n / 2);
#pragma unroll
        for (int t = 0; t < n / 2; ++t) {
          const float send = up ? part[t] : part[t + n / 2];
          const float keep = up ? part[t + n / 2] : part[t];
          part[t] = keep + __shfl_xor_sync(FULL, send, n / 2);
        }
      }
      const int j = (g0 + u / R) * RPW + lane / V, r = u % R;
      if (j < P && r < rep) {
        float s = part[0] * f.scale;
        if (QUANT) s = s * ksm[i * P + j];
        s = j < k_len ? s : NEG_INF;
        sc[(i * rep + r) * P + j] = s;
        mine = fmaxf(mine, s);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float m = u % R == r ? mine : NEG_INF;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1)
        m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
      pmax[r] = m;
    }
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < rep) pm[i * rep + r] = pmax[r];
    }
  };

  // Pass 1: score the chunk and take its maximum.  A resident chunk has
  // all of its K and V requested now; a longer one streams K in rounds.
  uint32_t kph = 0, vph = 0;
  float cm[R];
#pragma unroll
  for (int r = 0; r < R; ++r) cm[r] = NEG_INF;
  if (resident) request(0, cnt, true, true);
  for (int rd = 0; rd < rounds; ++rd) {
    const int first = rd * ring, c = min(ring, cnt - first);
    if (!resident) {
      __syncthreads();  // the last round's readers are done with the ring
      request(first, c, true, false);
    }
    for (int i = warp; i < c; i += W) {
      sm90::mbar_wait(kbar + 8 * i, (kph >> i) & 1u);
      float pmax[R];
      score_page(i, klen[i], pmax);
#pragma unroll
      for (int r = 0; r < R; ++r) cm[r] = fmaxf(cm[r], pmax[r]);
    }
    flip(kph, c);
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < rep) wred[warp * rep + r] = cm[r];
  }
  __syncthreads();
  if (threadIdx.x < rep) {
    float m = NEG_INF;
    for (int w = 0; w < W; ++w) m = fmaxf(m, wred[w * rep + threadIdx.x]);
    stat[threadIdx.x] = m;  // the chunk's maximum
  }
  // The chunk maxima of every rank: the lower ranks' give this rank's
  // starting max, all of them the slot's final max m_T.
  if (C > 1) sm90::cluster_sync(); else __syncthreads();
  if (threadIdx.x < rep) {
    const int r = threadIdx.x;
    float m0 = NEG_INF, mt = NEG_INF;
    for (int q = 0; q < C; ++q) {
      const float x = q == rank ? stat[r]
                                : sm90::ld_dsmem(sm90::map_rank(
                                      sm90::smem_u32(stat + r), q));
      if (q < rank) m0 = fmaxf(m0, x);
      mt = fmaxf(mt, x);
    }
    stat[rep + r] = m0;
    stat[2 * rep + r] = mt;
  }
  __syncthreads();

  // Pass 2: P against each page's running max m_t, rounded to bf16, into
  // acc and l scaled by exp(m_t - m_T).
  float acc[R][8], lsum[R], mrun[R], mfin[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    lsum[r] = 0.f;
    mrun[r] = r < rep ? stat[rep + r] : 0.f;
    mfin[r] = r < rep ? stat[2 * rep + r] : 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
  }
  for (int rd = 0; rd < rounds; ++rd) {
    const int first = rd * ring, c = min(ring, cnt - first);
    if (!resident) {  // the round's pages again, now with V
      __syncthreads();
      request(first, c, true, true);
      for (int i = warp; i < c; i += W) {
        sm90::mbar_wait(kbar + 8 * i, (kph >> i) & 1u);
        float pmax[R];
        score_page(i, klen[i], pmax);
      }
      flip(kph, c);
      __syncthreads();  // the round's scores and page maxima are in
    }
    for (int i = warp; i < c; i += W) {
      float mt[R], fac[R];
#pragma unroll
      for (int r = 0; r < R; ++r) mt[r] = mrun[r];
      for (int i2 = 0; i2 <= i; ++i2) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (r < rep) mt[r] = fmaxf(mt[r], pm[i2 * rep + r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) fac[r] = expf(mt[r] - mfin[r]);
      const TKV* vp = reinterpret_cast<const TKV*>(base + lay.v + i * lay.page);
      sm90::mbar_wait(vbar + 8 * i, (vph >> i) & 1u);
      const int k_len = klen[i];
      // The page's P once, a (row, head) a lane: l takes exp(m_t - m_T) p,
      // and the score becomes the PV weight exp(m_t - m_T) round(p), the
      // V scale folded into p before the rounding.
      float* wp = sc + i * rep * P;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= rep) continue;
        for (int j = lane; j < P; j += 32) {
          const float p = expf(wp[r * P + j] - mt[r]);
          lsum[r] = fmaf(fac[r], p, lsum[r]);
          const float pv = QUANT && j < k_len ? p * vsm[i * P + j] : p;
          wp[r * P + j] = fac[r] * __bfloat162float(__float2bfloat16(pv));
        }
      }
      __syncwarp();
#pragma unroll 2
      for (int ps = 0; ps < passes; ++ps) {
        const int j = ps * RPW + lane / V;
        if (j >= k_len) continue;  // dead rows add nothing: V selected to 0
        float vx[8];
        load8(vp + j * hd + col, vx);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r >= rep) continue;
          const float w = wp[r * P + j];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(w, vx[e], acc[r][e]);
        }
      }
    }
    for (int i2 = 0; i2 < c; ++i2) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < rep) mrun[r] = fmaxf(mrun[r], pm[i2 * rep + r]);
    }
    flip(vph, c);
  }

  // Warps: lanes of the same columns sum over their rows; then the block's
  // warps in order, then the cluster's blocks in rank order on rank 0.
#pragma unroll
  for (int o = V; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[r][e] += __shfl_xor_sync(FULL, acc[r][e], o);
    }
  }
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) lsum[r] += __shfl_xor_sync(FULL, lsum[r], o);
  }
  float* wr = wred + warp * rep * (hd + 1);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= rep) continue;
    if (lane < V) {
#pragma unroll
      for (int e = 0; e < 8; ++e) wr[r * (hd + 1) + col + e] = acc[r][e];
    }
    if (lane == 0) wr[r * (hd + 1) + hd] = lsum[r];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rep * (hd + 1); i += THREADS) {
    float a = 0.f;
    for (int w = 0; w < W; ++w) a += wred[w * rep * (hd + 1) + i];
    cacc[i] = a;
  }
  if (C > 1) sm90::cluster_sync(); else __syncthreads();
  if (rank == 0) {
    __nv_bfloat16* O = reinterpret_cast<__nv_bfloat16*>(f.o) +
                       ((int64_t)slot * f.h + (int64_t)g * rep) * hd;
    for (int i = threadIdx.x; i < rep * hd; i += THREADS) {
      const int r = i / hd, at = r * (hd + 1);
      float a = cacc[at + i % hd], l = cacc[at + hd];
      for (int q = 1; q < C; ++q) {
        a += sm90::ld_dsmem(sm90::map_rank(sm90::smem_u32(cacc + at + i % hd), q));
        l += sm90::ld_dsmem(sm90::map_rank(sm90::smem_u32(cacc + at + hd), q));
      }
      O[i] = __float2bfloat16(a / fmaxf(l, 1e-30f));
    }
  }
  if (C > 1) sm90::cluster_sync();  // the peers' partials stay until read
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

// Route B's limit is raised once per kernel, to its largest carve-up, so
// that a launch inside a CUDA-graph capture makes no attribute call.
template <auto kernel>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t s,
                   const DecodeArgs& f) {
  static const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(GROUP_MAX, PAGE_MAX, D_MAX));
  if (e != cudaSuccess) return e;
  kernel<<<grid, NT, smem, s>>>(f);
  return cudaGetLastError();
}

// A pool (pages, P, hkv, hd) seen as the 3-D tensor (hd, hkv, pages P),
// boxes of (hd, 1, P): one page's rows of one KV head.
bool make_pool_map(CUtensorMap* map, const void* pool, int isz, int hd,
                   int hkv, int pages, int P) {
  wgt::EncodeTiled encode = wgt::encode_tiled();
  if (!encode || reinterpret_cast<uintptr_t>(pool) % 16 || (hd * isz) % 16)
    return false;
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)hkv,
                              (cuuint64_t)pages * P};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * isz,
                                 (cuuint64_t)hkv * hd * isz};
  const cuuint32_t box[3] = {(cuuint32_t)hd, 1, (cuuint32_t)P};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, isz == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                              : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                3, const_cast<void*>(pool), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Pages a route-A block stages at once: the ring's budget, at most
// A_RING_MAX, and no more than the largest chunk (max_blocks / C rows).
int ring_pages(int page_size, int hd, int isz, int max_blocks, int cluster) {
  const int page = align_up(page_size * hd * isz, 128);
  const int chunk = (max_blocks + cluster - 1) / cluster;
  return std::max(1, std::min({A_RING_MAX, A_RING_BYTES / (2 * page), chunk}));
}

template <typename TKV, int R, int HD>
cudaError_t launch_a(const DecodeArgsA& f, int num_seqs, const void* k,
                     const void* v, int pages, cudaStream_t s) {
  constexpr int W = warps_a(R);
  // Raised once, so that a launch inside a CUDA-graph capture makes no
  // attribute call.
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_decode_split<TKV, R, HD, W>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, A_SMEM_LIMIT);
  if (attr != cudaSuccess) return attr;
  const int isz = (int)sizeof(TKV);
  const LayoutA lay(f.ring, f.h / f.hkv, f.page_size, HD, isz, W);
  const size_t smem = (size_t)lay.total + 128;  // + alignment slack
  if (smem > (size_t)A_SMEM_LIMIT) return cudaErrorInvalidValue;
  CUtensorMap mk{}, mv{};
  if (!make_pool_map(&mk, k, isz, f.hd, f.hkv, pages, f.page_size) ||
      !make_pool_map(&mv, v, isz, f.hd, f.hkv, pages, f.page_size))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(num_seqs * f.cluster, f.hkv, 1);
  cfg.blockDim = dim3(32 * W);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attrs[1];
  if (f.cluster > 1) {
    attrs[0].id = cudaLaunchAttributeClusterDimension;
    attrs[0].val.clusterDim.x = f.cluster;
    attrs[0].val.clusterDim.y = 1;
    attrs[0].val.clusterDim.z = 1;
    cfg.attrs = attrs;
    cfg.numAttrs = 1;
  }
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, flash_decode_split<TKV, R, HD, W>, mk, mv, f);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename TKV, int HD>
cudaError_t launch_a_group(const DecodeArgsA& f, int num_seqs, const void* k,
                           const void* v, int pages, cudaStream_t s) {
  const int rep = f.h / f.hkv;
  if (rep <= 1) return launch_a<TKV, 1, HD>(f, num_seqs, k, v, pages, s);
  if (rep <= 2) return launch_a<TKV, 2, HD>(f, num_seqs, k, v, pages, s);
  if (rep <= 4) return launch_a<TKV, 4, HD>(f, num_seqs, k, v, pages, s);
  return launch_a<TKV, 8, HD>(f, num_seqs, k, v, pages, s);
}

template <typename TKV>
cudaError_t launch_a_dims(const DecodeArgsA& f, int num_seqs, const void* k,
                          const void* v, int pages, cudaStream_t s) {
  switch (f.hd) {
    case 64: return launch_a_group<TKV, 64>(f, num_seqs, k, v, pages, s);
    case 128: return launch_a_group<TKV, 128>(f, num_seqs, k, v, pages, s);
  }
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// dtype: q's (0 fp32, 1 bf16); the pools are q's type when k_scale and
// v_scale are null, int8 when both are given.  route: ROUTE_A (bf16 q
// within route A's limits, a cluster of `cluster` blocks a (slot, KV
// head)) or ROUTE_B (one block a (slot, KV head); `cluster` ignored).
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            void* o, const int* table, const int* bstart,
                            const float* k_scale, const float* v_scale,
                            int num_seqs, int h, int hkv, int hd,
                            int page_size, int num_pages, int max_blocks,
                            int cluster, float scale, int dtype, int route,
                            void* stream) {
  if (num_seqs < 1 || hkv < 1 || hkv > 65535 || h % hkv != 0 ||
      h / hkv > GROUP_MAX || hd < 1 || hd > D_MAX || page_size < 1 ||
      page_size > PAGE_MAX || (k_scale == nullptr) != (v_scale == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool quant = k_scale != nullptr;
  if (route == ROUTE_A) {
    if (dtype != 1 || h / hkv > A_GROUP_MAX || !head_dim_a(hd) ||
        page_size > A_PAGE_MAX || page_size % 4 != 0 || num_pages < 1 ||
        max_blocks < 1 || cluster < 1 || cluster > MAX_CLUSTER ||
        !aligned16(q) || !aligned16(o) ||
        (quant && !(aligned16(k_scale) && aligned16(v_scale))))
      return cudaErrorInvalidValue;
    const int ring = ring_pages(page_size, hd, quant ? 1 : 2, max_blocks,
                                cluster);
    DecodeArgsA f{q,   o,  table, bstart,    k_scale, v_scale, h,
                  hkv, hd, page_size, ring, cluster,  scale};
    return quant ? launch_a_dims<signed char>(f, num_seqs, k, v, num_pages, s)
                 : launch_a_dims<__nv_bfloat16>(f, num_seqs, k, v, num_pages,
                                                s);
  }
  if (route != ROUTE_B) return cudaErrorInvalidValue;
  DecodeArgs f{q,       k,       v, o,   table, bstart,    k_scale,
               v_scale, h,       hkv, hd, page_size, scale};
  dim3 grid(num_seqs, hkv);
  const size_t smem = smem_bytes(h / hkv, page_size, hd);
  if (dtype == 1)
    return quant ? launch<flash_decode_kernel<__nv_bfloat16, signed char>>(
                       grid, smem, s, f)
                 : launch<flash_decode_kernel<__nv_bfloat16, __nv_bfloat16>>(
                       grid, smem, s, f);
  if (dtype == 0)
    return quant ? launch<flash_decode_kernel<float, signed char>>(grid, smem,
                                                                  s, f)
                 : launch<flash_decode_kernel<float, float>>(grid, smem, s, f);
  return cudaErrorInvalidValue;
}
