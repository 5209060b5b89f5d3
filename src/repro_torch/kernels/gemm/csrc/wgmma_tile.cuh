// The bf16 wgmma tile of Hopper (sm_90a), shared by the planned GEMM
// (gemm.cu) and the grouped GEMM's forward (../../grouped_gemm/csrc/
// grouped.cu): the TMA ring (routes A and B), the ring fed through
// registers (route C), the staged epilogue and its 16-byte stores, and the
// host-side tensor-map encoding.  The PTX building blocks are
// gemm_sm90.cuh's.
//
// A Tile is a BM x BN window of C at (orow, ocol) of which the block owns
// [r0, r1) x [c0, c1).  A's rows come from batch `batch` of the A map, B's
// panel from batch `bbatch` of the B map (the GEMM's batch; the grouped
// GEMM's expert).  `live` counts the window's rows, from orow, that hold
// owned rows: a bm >= 64 tile loads and multiplies only the 64-row A boxes
// that reach into them (row-aware tiles), the rest of its consumer
// warpgroups issue no products.  Every accumulator row depends on its own
// A row alone, so A rows that the tile loads but does not own (another
// group's, or padding that holds NaN) reach only rows that are never
// stored.
//
// A GRAD tile (the dense GEMM's backward epilogue) ends in the activation's
// derivative instead: dpre = dy * act'(acc + C_in + bias), with the
// cotangent dy read the way C_in is.  GRAD is a template parameter, so the
// forward tiles compile as they do without it.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "gemm_sm90.cuh"

namespace wgt {

constexpr int BK = 32;        // K panel (H100_SXM.k_panel)
constexpr int WG_THREADS = 128;       // one consumer warpgroup
constexpr int PRODUCER_THREADS = 32;  // the TMA producer warp
constexpr int LD_WARPGROUPS = 2;      // route C's warpgroups, every shape
// A ring stage holds one K panel: K-major rows of ROWB = 64 bytes.
constexpr int ROWB = 2 * BK;
constexpr int ABOX = 64;  // rows of one A box for bm >= 64
// The TMA ring: STAGES stages of an A slot (64 rows a consumer warpgroup)
// and a B slot (128 rows or columns), each on a 1024-byte boundary, with
// 1024 bytes of alignment slack in front and two mbarriers a stage
// behind.  Six 16 KB stages keep 96 KB of loads in flight a block, and
// two blocks fit an SM.
constexpr int STAGES = 6;
constexpr int B_SLOT = 128 * ROWB;
__host__ __device__ constexpr int a_slot(int nwg) { return nwg * 64 * ROWB; }
__host__ __device__ constexpr int stage_bytes(int nwg) {
  return a_slot(nwg) + B_SLOT;
}
__host__ __device__ constexpr int ring_bytes(int nwg) {
  return 1024 + STAGES * stage_bytes(nwg) + 2 * STAGES * 8;
}
// The epilogue stages the fp32 tile, [BM][BN + 4], in the ring; route C's
// block holds that tile, which outgrows its two stages.
constexpr int STAGED_TILE_BYTES = 128 * (128 + 4) * 4;
static_assert(STAGES * stage_bytes(2) >= STAGED_TILE_BYTES &&
                  STAGES * stage_bytes(1) >= 64 * (128 + 4) * 4,
              "the staged tile fits the ring");
static_assert(2 * stage_bytes(LD_WARPGROUPS) <= STAGED_TILE_BYTES,
              "route C's two stages fit its block");
constexpr int LD_SMEM = 1024 + STAGED_TILE_BYTES;
// A tile's `live` when every row of its window may be owned.
constexpr int ALL_ROWS = 1 << 30;

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

// The TMA tensor maps of one call: A in 16-row boxes (bm 16 tiles), A in
// ABOX-row boxes (bm 64 / 128), B.
struct Maps {
  const CUtensorMap* a16;
  const CUtensorMap* a;
  const CUtensorMap* b;
};

// One block's tile: the window's origin, the owned rectangle, A's and B's
// batches, the rows that may be owned.
struct Tile {
  GemmArgs g;
  int batch, orow, ocol, r0, r1, c0, c1;
  int rank, split, nwg;
  int bbatch, live;
  unsigned char* smem;
  const void* dy;    // (nb, m, n) cotangent of a GRAD tile
  int dy_dtype;
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

__device__ __forceinline__ bool has_bias(int epi) {
  return epi == EPI_BIAS || epi == EPI_BIAS_GELU || epi == EPI_BIAS_SILU;
}

// The activation of an epilogue (gelu is the tanh approximation).
__device__ __forceinline__ float activate(float x, int epi) {
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

// The derivative of the activation at x, as autograd of the plain form
// (kernels/epilogue.py) gives it: gelu's tanh form differentiated term by
// term, silu's s (1 + x (1 - s)), relu's step (1 at 0, clamp_min's).
__device__ __forceinline__ float activate_grad(float x, int epi) {
  if (epi == EPI_GELU || epi == EPI_BIAS_GELU) {
    const float k0 = 0.7978845608028654f, k1 = 0.044715f;
    const float x2 = x * x;
    const float t = tanhf(k0 * (x + k1 * x2 * x));
    return 0.5f * (1.f + t) +
           0.5f * x * (1.f - t * t) * k0 * (1.f + 3.f * k1 * x2);
  }
  if (epi == EPI_SILU || epi == EPI_BIAS_SILU) {
    const float s = 1.f / (1.f + expf(-x));
    return s * (1.f + x * (1.f - s));
  }
  if (epi == EPI_RELU) return x >= 0.f ? 1.f : 0.f;
  return 1.f;
}

__device__ __forceinline__ float epilogue(float x, const GemmArgs& g,
                                          int col) {
  if (has_bias(g.epi)) x += load_f(g.bias, g.bias_dtype, col);
  return activate(x, g.epi);
}

// Eight neighbouring fp32 values from p[i..i+8) of a dtype: 16-byte loads
// where the address allows, else element by element (n < 8 valid).
__device__ __forceinline__ void load8(const void* p, int dtype, int64_t i,
                                      int n, float v[8]) {
  const int esize = dtype == DT_BF16 ? 2 : 4;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p) + (uintptr_t)i * esize;
  if (n == 8 && addr % 16 == 0) {
    if (dtype == DT_BF16) {
      const uint4 u = *reinterpret_cast<const uint4*>(addr);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        v[2 * e] = f.x;
        v[2 * e + 1] = f.y;
      }
    } else {
      const float4 a = reinterpret_cast<const float4*>(addr)[0];
      const float4 b = reinterpret_cast<const float4*>(addr)[1];
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (e < n) v[e] = load_f(p, dtype, i + e);
}

// Stores v[lo..hi) to p[i + lo .. i + hi): one or two 16-byte stores when
// all eight are stored and the address allows, else element by element.
__device__ __forceinline__ void store8(void* p, int dtype, int64_t i, int lo,
                                       int hi, const float v[8]) {
  const int esize = dtype == DT_BF16 ? 2 : 4;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p) + (uintptr_t)i * esize;
  if (lo == 0 && hi == 8 && addr % 16 == 0) {
    if (dtype == DT_BF16) {
      uint4 u;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
      *reinterpret_cast<uint4*>(addr) = u;
    } else {
      reinterpret_cast<float4*>(addr)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(addr)[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (e >= lo && e < hi) store_f(p, dtype, i + e, v[e]);
}

// One consumer warpgroup's share of a BM x BN tile.  bm >= 64: warpgroup w
// owns rows [64 w, 64 w + 64) and all BN columns (BN / 2 fp32 registers a
// thread).  bm 16 (swap-AB): warpgroup w owns the 64-column halves h = w,
// w + nwg, ... of the window's weight columns (8 registers a half).
template <int BM, int BN>
struct Acc {
  static constexpr bool SWAP = BM == 16;
  static constexpr int HALVES = BN / 64;
  static constexpr int N = SWAP ? 8 * HALVES : BN / 2;
  float d[N];
};

// Consumer warpgroups with work: for bm >= 64 one per 64-row A box that
// reaches into the live rows; for the swap-AB tile the halves (at most
// nwg).
template <int BM, int BN>
__device__ __forceinline__ int active_wgs(const Tile& t) {
  return BM == 16 ? min(t.nwg, BN / 64) : min(BM / 64, (t.live + 63) / 64);
}

// The products of one stage: BK / 16 k-steps.  `a` and `b` are the
// shared-memory addresses of the stage's A and B slots.
template <int BM, int BN>
__device__ __forceinline__ void panel_mma(Acc<BM, BN>& acc, uint32_t a,
                                          uint32_t b, int wg, int nwg,
                                          int nt) {
  using namespace sm90;
  if constexpr (BM == 16) {
#pragma unroll
    for (int hh = 0; hh < Acc<BM, BN>::HALVES; ++hh) {
      const int h = wg + hh * nwg;
      if (h >= Acc<BM, BN>::HALVES) continue;
      float* d = acc.d + 8 * hh;
      const uint32_t w = b + h * 64 * ROWB;
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        const uint64_t act = desc_k64(a + ks * 32);
        if (nt)
          wgmma_n16<0, 0>(d, desc_k64(w + ks * 32), act);
        else
          wgmma_n16<1, 0>(d, desc_mn128(w + ks * 2048), act);
      }
    }
  } else {
    const uint32_t arow = a + wg * 64 * ROWB;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const uint64_t da = desc_k64(arow + ks * 32);
      if constexpr (BN == 64) {
        if (nt) wgmma_n64<0, 0>(acc.d, da, desc_k64(b + ks * 32));
        else    wgmma_n64<0, 1>(acc.d, da, desc_mn128(b + ks * 2048));
      } else {
        if (nt) wgmma_n128<0, 0>(acc.d, da, desc_k64(b + ks * 32));
        else    wgmma_n128<0, 1>(acc.d, da, desc_mn128(b + ks * 2048));
      }
    }
  }
}

// The split-K reduction (partial sums into the cluster leader, in rank
// order) and the epilogue from the registers (GRAD: the backward
// epilogue).  Every thread of the block calls it: the cluster barriers
// count them all.
template <int BM, int BN, bool GRAD = false>
__device__ __forceinline__ void finish_tile(Acc<BM, BN>& acc, const Tile& t,
                                            bool consumer) {
  using namespace sm90;
  constexpr int N = Acc<BM, BN>::N;
  const int wg = threadIdx.x / WG_THREADS;
  const int nwg_act = active_wgs<BM, BN>(t);
  const int nact = WG_THREADS * nwg_act;
  const int ct = threadIdx.x;  // consumer thread index, < nact
  __syncwarp();  // the cluster barrier is .aligned
  if (t.split > 1) {
    // The ring is free once every consumer's products are done; the
    // partial sums reuse it.
    if (consumer) {
      bar_sync(1, nact);
      fence_proxy_async();
      if (t.rank != 0) {
        float* red = reinterpret_cast<float*>(t.smem);
#pragma unroll
        for (int i = 0; i < N; ++i) red[i * nact + ct] = acc.d[i];
      }
    }
    cluster_sync();
    if (consumer && t.rank == 0) {
      const uint32_t red = smem_u32(t.smem);
      for (int peer = 1; peer < t.split; ++peer) {
        const uint32_t remote = map_rank(red, peer);
#pragma unroll
        for (int i = 0; i < N; ++i)
          acc.d[i] += ld_dsmem(remote + 4u * (uint32_t)(i * nact + ct));
      }
    }
    cluster_sync();  // the peers' buffers stay alive until read
  }
  if (!consumer || t.rank != 0) return;
  // Stage the fp32 tile in the (free) ring as [BM][BN + 4], row by row.
  constexpr int LD = BN + 4;
  float* st = reinterpret_cast<float*>(t.smem);
  if (t.split == 1) {
    bar_sync(1, nact);  // every consumer's products are done
    fence_proxy_async();
  }
  const int lane = threadIdx.x % 32, w = (threadIdx.x / 32) % 4;
  const int qr = 16 * w + lane / 4, qc = 2 * (lane % 4);
  if constexpr (BM == 16) {
    // C^T fragments: rows are weight columns, columns are activation rows.
#pragma unroll
    for (int hh = 0; hh < Acc<BM, BN>::HALVES; ++hh) {
      const int h = wg + hh * t.nwg;
      if (h >= Acc<BM, BN>::HALVES) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            st[(8 * j + qc + c) * LD + 64 * h + qr + 8 * i] =
                acc.d[8 * hh + 4 * j + 2 * i + c];
    }
  } else {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(st + (64 * wg + qr + 8 * i) * LD + 8 * j +
                                   qc) =
            make_float2(acc.d[4 * j + 2 * i], acc.d[4 * j + 2 * i + 1]);
  }
  // A thread's eight columns are the same in every row it stores (nact is
  // a multiple of BN / 8), so it loads their bias once a tile.
  const GemmArgs& g = t.g;
  const int lc = ct % (BN / 8) * 8;
  float bv[8] = {};
  if (has_bias(g.epi) && t.ocol + lc < g.n)
    load8(g.bias, g.bias_dtype, t.ocol + lc, min(g.n - t.ocol - lc, 8), bv);
  bar_sync(1, nact);

  // Rows of eight columns: C_in, bias, activation (GRAD: dy times its
  // derivative) and the cast, stored where the tile owns them.  Only the
  // active warpgroups' rows are staged.
  const int staged = BM == 16 ? BM : 64 * nwg_act;
  for (int q = ct; q < staged * BN / 8; q += nact) {
    const int lr = q / (BN / 8);
    const int r = t.orow + lr, c = t.ocol + lc;
    if (r < t.r0 || r >= t.r1) continue;
    const int lo = max(t.c0 - c, 0), hi = min(t.c1 - c, 8);
    if (lo >= hi) continue;
    float v[8];
    const float4 a = *reinterpret_cast<const float4*>(st + lr * LD + lc);
    const float4 b = *reinterpret_cast<const float4*>(st + lr * LD + lc + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    const int64_t o = ((int64_t)t.batch * g.m + r) * g.n + c;
    const int n = min(g.n - c, 8);
    if (g.c) {
      float cin[8] = {};
      load8(g.c, g.c_dtype, o, n, cin);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += cin[e];
    }
    if constexpr (GRAD) {
      float dy[8] = {};
      load8(t.dy, t.dy_dtype, o, n, dy);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = dy[e] * activate_grad(v[e] + bv[e], g.epi);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = activate(v[e] + bv[e], g.epi);
    }
    store8(g.out, g.out_dtype, o, lo, hi, v);
  }
}

// Routes A and B: the TMA ring.  Block = nwg consumer warpgroups and one
// producer warp (the last).  Each block sums the panels [p0, p1) of its
// split-K share.  GRAD: the backward epilogue (finish_tile).
struct TmaRoute {
  template <int BM, int BN, bool GRAD = false>
  static __device__ __forceinline__ void run(const Tile& t, const Maps& m) {
    using namespace sm90;
    const GemmArgs& g = t.g;
    const int steps = (g.k + BK - 1) / BK;
    const int p0 = (int)((int64_t)t.rank * steps / t.split);
    const int p1 = (int)((int64_t)(t.rank + 1) * steps / t.split);
    constexpr int S = STAGES;
    const uint32_t base = smem_u32(t.smem);
    const uint32_t stage = stage_bytes(t.nwg);
    const uint32_t bars = base + S * stage;  // full[s], then empty[s]
    const int wg = threadIdx.x / WG_THREADS;
    const int nact = active_wgs<BM, BN>(t);
    if (threadIdx.x == 0) {
      for (int s = 0; s < S; ++s) {
        mbar_init(bars + 8 * s, 1);
        mbar_init(bars + 8 * (S + s), 4 * nact);
      }
      mbar_init_fence();
    }
    __syncthreads();

    Acc<BM, BN> acc;
#pragma unroll
    for (int i = 0; i < Acc<BM, BN>::N; ++i) acc.d[i] = 0.f;
    const bool consumer = wg < nact;
    if (wg == t.nwg) {
      // Producer: one thread keeps up to S stages in flight.  A boxes wholly
      // past the last row or the live rows, and B boxes wholly past the
      // last column, are not loaded: their slot rows only reach outputs
      // that are never stored.
      if (threadIdx.x % 32 == 0) {
        constexpr int AROWS = BM == 16 ? 16 : ABOX;
        const CUtensorMap* mapa = BM == 16 ? m.a16 : m.a;
        const int arows = min(g.m - t.orow, t.live);
        const int abox = min(BM / AROWS, (arows + AROWS - 1) / AROWS);
        const int bbox = min(BN / 64, (g.n - t.ocol + 63) / 64);
        const uint32_t bytes = (abox * AROWS + bbox * 64) * ROWB;
        int s = 0;
        uint32_t phase = 0;
        for (int p = p0; p < p1; ++p) {
          mbar_wait(bars + 8 * (S + s), phase ^ 1);
          const uint32_t full = bars + 8 * s;
          const uint32_t a = base + s * stage, b = a + a_slot(t.nwg);
          mbar_expect_tx(full, bytes);
          for (int i = 0; i < abox; ++i)
            tma_load_3d(a + AROWS * ROWB * i, mapa, full, p * BK,
                        t.orow + AROWS * i, t.batch);
          for (int h = 0; h < bbox; ++h) {
            if (g.nt)
              tma_load_3d(b + 64 * ROWB * h, m.b, full, p * BK,
                          t.ocol + 64 * h, t.bbatch);
            else
              tma_load_3d(b + 64 * ROWB * h, m.b, full, t.ocol + 64 * h,
                          p * BK, t.bbatch);
          }
          if (++s == S) { s = 0; phase ^= 1; }
        }
      }
    } else if (consumer) {
      int s = 0, prev = -1;
      uint32_t phase = 0;
      for (int p = p0; p < p1; ++p) {
        mbar_wait(bars + 8 * s, phase);
        __syncwarp();  // wgmma is .aligned: the warp reconverges first
        const uint32_t a = base + s * stage;
        fence_regs(acc.d);
        wgmma_fence();
        panel_mma<BM, BN>(acc, a, a + a_slot(t.nwg), wg, t.nwg, g.nt);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done
        fence_regs(acc.d);
        if (prev >= 0 && threadIdx.x % 32 == 0)
          mbar_arrive(bars + 8 * (S + prev));
        prev = s;
        if (++s == S) { s = 0; phase ^= 1; }
      }
      wgmma_wait<0>();
      fence_regs(acc.d);
    }
    finish_tile<BM, BN, GRAD>(acc, t, consumer);
  }
};

// Route C: every thread loads pairs of neighbouring elements of the next
// stage into registers while the current one is multiplied, then writes
// them in the swizzled layouts TMA would have written.  GRAD as TmaRoute's.
struct LdRoute {
  template <int BM, int BN, bool GRAD = false>
  static __device__ __forceinline__ void run(const Tile& t, const Maps&) {
    using namespace sm90;
    constexpr int THREADS = LD_WARPGROUPS * WG_THREADS;
    constexpr int PER = (BM + BN) * BK / 2 / THREADS;  // pairs a thread
    static_assert((BM + BN) * BK / 2 % THREADS == 0, "stage split");
    const GemmArgs& g = t.g;
    const unsigned short* A = reinterpret_cast<const unsigned short*>(g.a) +
                              (int64_t)t.batch * g.m * g.k;
    const unsigned short* B = reinterpret_cast<const unsigned short*>(g.b) +
                              (int64_t)t.bbatch * g.k * g.n;
    const uint32_t base = smem_u32(t.smem);
    const uint32_t stage = stage_bytes(LD_WARPGROUPS);
    const int wg = threadIdx.x / WG_THREADS;
    const bool consumer = wg < active_wgs<BM, BN>(t);
    const int steps = (g.k + BK - 1) / BK;
    uint32_t v[PER];

    // Pair e covers elements 2e and 2e + 1 of the stage's A (BM x BK),
    // then B (BN x BK for "nt", BK x BN for "nn"), fastest dimension last.
    auto load = [&](int p) {
      const int k0 = p * BK;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int e = 2 * (threadIdx.x + i * THREADS);
        int r, c, rows, cols;
        const unsigned short* src;
        if (e < BM * BK) {
          r = t.orow + e / BK; c = k0 + e % BK; rows = g.m; cols = g.k;
          src = A;
        } else if (g.nt) {
          const int f = e - BM * BK;
          r = t.ocol + f / BK; c = k0 + f % BK; rows = g.n; cols = g.k;
          src = B;
        } else {
          const int f = e - BM * BK;
          r = k0 + f / BN; c = t.ocol + f % BN; rows = g.k; cols = g.n;
          src = B;
        }
        const unsigned short* row = src + (int64_t)r * cols;
        const bool in = r < rows;
        const uint32_t lo = in && c < cols ? row[c] : 0u;
        const uint32_t hi = in && c + 1 < cols ? row[c + 1] : 0u;
        v[i] = lo | hi << 16;
      }
    };
    auto store = [&](int s) {
      unsigned char* a = t.smem + s * stage;
      unsigned char* b = a + a_slot(LD_WARPGROUPS);
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int e = 2 * (threadIdx.x + i * THREADS);
        uint32_t off;
        unsigned char* dst;
        if (e < BM * BK || g.nt) {  // K-major rows of ROWB bytes
          const int f = e < BM * BK ? e : e - BM * BK;
          const int r = f / BK, kk = f % BK;
          off = r * ROWB +
                (((kk >> 3) ^ ((r * ROWB >> 7) & (ROWB / 16 - 1))) << 4) +
                (kk & 7) * 2;
          dst = e < BM * BK ? a : b;
        } else {  // MN-major, 128-byte swizzle, 64-column chunks
          const int f = e - BM * BK, kk = f / BN, cc = f % BN;
          off = (cc >> 6) * (BK * 128) + kk * 128 +
                ((((cc & 63) >> 3) ^ (kk & 7)) << 4) + (cc & 7) * 2;
          dst = b;
        }
        *reinterpret_cast<uint32_t*>(dst + off) = v[i];
      }
      fence_proxy_async();
    };

    Acc<BM, BN> acc;
#pragma unroll
    for (int i = 0; i < Acc<BM, BN>::N; ++i) acc.d[i] = 0.f;
    load(0);
    store(0);
    __syncthreads();
    for (int p = 0; p < steps; ++p) {
      const int s = p & 1;
      if (p + 1 < steps) load(p + 1);
      if (consumer) {
        const uint32_t a = base + s * stage;
        fence_regs(acc.d);
        wgmma_fence();
        panel_mma<BM, BN>(acc, a, a + a_slot(LD_WARPGROUPS), wg,
                          LD_WARPGROUPS, g.nt);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc.d);
      }
      if (p + 1 < steps) store(s ^ 1);
      __syncthreads();
    }
    finish_tile<BM, BN, GRAD>(acc, t, consumer);
  }
};

// ---------------------------------------------------------------------------
// Host side: tensor maps.
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up through the CUDA runtime's entry-point
// query, so the library needs no -lcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D bf16 map over (inner, outer, batch) with a (box0, box1, 1) box.
// The extents are the logical ones: TMA fills zeros past them.
inline bool make_map(CUtensorMap* map, const void* ptr, uint64_t inner,
                     uint64_t outer, uint64_t batch, uint32_t box0,
                     uint32_t box1, CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = encode_tiled();
  if (!encode || reinterpret_cast<uintptr_t>(ptr) % 16 || (inner * 2) % 16)
    return false;
  const cuuint64_t dims[3] = {inner, outer, batch};
  const cuuint64_t strides[2] = {inner * 2, inner * outer * 2};
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// K-major boxes (A, and B of the "nt" layout): rows of ROWB bytes in the
// matching swizzle.
constexpr CUtensorMapSwizzle KMAJOR_SWIZZLE =
    ROWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;

}  // namespace wgt
