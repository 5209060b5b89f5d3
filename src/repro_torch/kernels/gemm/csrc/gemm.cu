// Planned GEMM for Hopper (sm_90a): out = epilogue(C? + A @ op(B)).
//
// Replaces the reference package's two TPU GEMM kernels
// (src/repro/kernels/gemm/kernel.py):
//   * gemm_fused  <- build_fused_gemm_kernel (_fused_kernel_body): one
//     launch walks a whole plan's tile table, one tile per table row,
//     batch as the second grid dimension;
//   * gemm_region <- build_gemm_kernel (_gemm_kernel_body): one launch per
//     plan region, writing straight into the full C (no operand slices,
//     no stitching).
// Both are thin __global__ entry points over one tile routine per (route,
// shape) that computes a BM x BN window of C and stores only the elements
// the tile owns, so every C element is stored by exactly one thread block.
//
// What bounds it on the H100 at the main-path shapes:
//   * prefill, training and every read-out at M >= 64 (e.g. Qwen3's
//     1024 x 151936 x 1024 training read-out): hundreds of flops per byte,
//     above the card's ~295 flop/byte ridge, so the tensor cores' 989
//     TFLOP/s -- and, with 128 x 128 tiles of 32-deep panels, the L2's
//     rate of feeding 16 KB a panel to every SM;
//   * decode, M <= 16: every weight byte is read once for 2 M flops, so
//     3.35 TB/s of HBM, and a grid of one block per 128 weight columns
//     (8-32 blocks for Qwen3's and phi3.5's projections) leaves most of
//     the 132 SMs idle.
// The bf16 routes (chosen per call in kernel.py, which counts them):
//   (A) bm 64 / 128: a ring of STAGES K panels (two blocks an SM) in
//       dynamic shared memory, filled by TMA from 3-D
//       tensor maps over (batch, rows, cols), so the hardware's
//       out-of-bounds zero fill masks every edge and no padding is read,
//       and completed on mbarriers.  One producer warp starts the loads
//       (64-row boxes of A, 64-row or 64-column boxes of B); one consumer
//       warpgroup per 64 rows runs wgmma m64nBNk16 with fp32
//       accumulators in registers and releases each stage as the next
//       one's products start.
//   (B) bm 16, the decode shape: the same ring, computed swap-AB (C^T =
//       B^T A^T: the weight columns fill wgmma's 64 rows, the <= 16
//       activation rows are its N = 16), so a 16-row window costs one
//       m64n16 product per 64 weight columns instead of a mostly masked
//       m64 one.  Where the plan has fewer tiles than the card has SMs,
//       kernel.py splits K over a thread-block cluster of up to MAX_CLUSTER
//       blocks; each block sums its share of the panels, and the partial
//       sums reach the cluster's leader through distributed shared memory
//       in rank order (deterministic).  The leader alone runs the epilogue
//       and stores.  The split applies to route A's tiles too.
//   (C) operands TMA cannot take (a base that is not 16-byte aligned, or a
//       row stride that is not a multiple of 16 bytes, e.g. K = 1001): all
//       threads load the next panel through registers, predicated with
//       zero fill, into a swizzled two-stage ring while the current one is
//       multiplied, feeding the same wgmma and epilogue code.  cp.async
//       is not usable there: it copies 4, 8 or 16 bytes from an address
//       aligned to that size, and such rows start on 2-byte boundaries.
// Every route stages the finished fp32 tile in the ring's shared memory
// and stores rows of eight owned columns with 16-byte accesses.  Blocks
// take tiles in bands of RASTER_ROWS tile rows, a band column by column,
// so the blocks in flight share B's panels in L2 (a read-out's B is read
// from HBM about once, not once per tile row).
// fp32 operands keep register-blocked CUDA-core FMAs (never TF32).
//
// The epilogue runs on the fp32 accumulator: + C_in, + bias, activation
// (gelu is the tanh approximation), then the cast to the output type.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

#include "gemm_sm90.cuh"

namespace {

constexpr int NT = 128;       // threads per block of the fp32 route
constexpr int BK = 32;        // K panel (H100_SXM.k_panel)
constexpr int MAX_CLUSTER = 8;  // split-K blocks (H100_SXM.gemm_max_cluster)
constexpr int WG_THREADS = 128;       // one consumer warpgroup
constexpr int PRODUCER_THREADS = 32;  // the TMA producer warp
constexpr int LD_WARPGROUPS = 2;      // route C's warpgroups, every shape
constexpr int SMEM_BYTES = 2 * BK * (128 + 4) * 4;  // fp32 route, static
// A ring stage holds one K panel: K-major rows of ROWB = 64 bytes.
constexpr int ROWB = 2 * BK;
constexpr int ABOX = 64;  // rows of one A box for bm >= 64
// A region's windows are taken in bands of RASTER_ROWS tile rows, a band
// column by column (the fused table comes in that order from kernel.py),
// so the blocks in flight share B's column panels in L2.
constexpr int RASTER_ROWS = 8;
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

enum { EPI_NONE = 0, EPI_BIAS, EPI_GELU, EPI_SILU, EPI_RELU, EPI_BIAS_GELU,
       EPI_BIAS_SILU };
enum { DT_F32 = 0, DT_BF16 = 1 };
enum { ROUTE_A = 0, ROUTE_B = 1, ROUTE_C = 2 };

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

// Where a block's tile comes from: a row of the fused kernel's tile table,
// or one window of a region's grid.  `split` blocks (a cluster) share a
// tile; `nwg` is the number of consumer warpgroups.
struct TileSrc {
  const int* table;   // (tiles, 8) rows, or null for a region
  const int* blocks;  // (block_id -> shape, bm_e, bn_e)
  int shape, row0, col0, rows, cols, tiles_r, tiles_c;  // the region
  int split, nwg;
};

// The TMA tensor maps of one call: A in 16-row boxes (bm 16 tiles), A in
// ABOX-row boxes (bm 64 / 128), B.
struct Maps {
  const CUtensorMap* a16;
  const CUtensorMap* a;
  const CUtensorMap* b;
};

// One block's tile: the window's origin, the owned rectangle, the batch.
struct Tile {
  GemmArgs g;
  int batch, orow, ocol, r0, r1, c0, c1;
  int rank, split, nwg;
  unsigned char* smem;
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

// C_in joins the fp32 accumulator before bias and activation (ref_gemm's
// order).
__device__ __forceinline__ float finish_value(const GemmArgs& g, int64_t o,
                                              int col, float acc) {
  if (g.c) acc += load_f(g.c, g.c_dtype, o);
  return epilogue(acc, g, col);
}

// One output element of the tile, if the tile owns it.
__device__ __forceinline__ void finish(const GemmArgs& g, int batch, int r,
                                       int c, float acc, int r0, int r1,
                                       int c0, int c1) {
  if (r < r0 || r >= r1 || c < c0 || c >= c1) return;
  const int64_t o = (int64_t)batch * g.m * g.n + (int64_t)r * g.n + c;
  store_f(g.out, g.out_dtype, o, finish_value(g, o, c, acc));
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

// ---------------------------------------------------------------------------
// fp32: register-blocked fp32 FMAs (no TF32), 128 threads.
// ---------------------------------------------------------------------------

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

struct F32Route {
  template <int BM, int BN>
  static __device__ __forceinline__ void run(const Tile& t) {
    tile_f32<BM, BN>(t.g, t.batch, t.orow, t.ocol, t.r0, t.r1, t.c0, t.c1,
                     t.smem);
  }
};

// ---------------------------------------------------------------------------
// bf16: the wgmma tile, shared by routes A, B (TMA ring) and C (loads
// through registers).
// ---------------------------------------------------------------------------

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

// Consumer warpgroups with work: bm / 64 for route A, the halves (at most
// nwg) for the swap-AB tile.
template <int BM, int BN>
__device__ __forceinline__ int active_wgs(int nwg) {
  return BM == 16 ? min(nwg, BN / 64) : BM / 64;
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
// order) and the epilogue from the registers.  Every thread of the block
// calls it: the cluster barriers count them all.
template <int BM, int BN>
__device__ __forceinline__ void finish_tile(Acc<BM, BN>& acc, const Tile& t,
                                            bool consumer) {
  using namespace sm90;
  constexpr int N = Acc<BM, BN>::N;
  const int wg = threadIdx.x / WG_THREADS;
  const int nact = WG_THREADS * active_wgs<BM, BN>(t.nwg);
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
  bar_sync(1, nact);

  // Rows of eight columns: C_in, bias, activation and the cast, stored
  // where the tile owns them.
  const GemmArgs& g = t.g;
  for (int q = ct; q < BM * BN / 8; q += nact) {
    const int lr = q / (BN / 8), lc = q % (BN / 8) * 8;
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
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = epilogue(v[e], g, min(c + e, g.n - 1));
    store8(g.out, g.out_dtype, o, lo, hi, v);
  }
}

// Routes A and B: the TMA ring.  Block = nwg consumer warpgroups and one
// producer warp (the last).  Each block sums the panels [p0, p1) of its
// split-K share.
struct TmaRoute {
  template <int BM, int BN>
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
    const int nact = active_wgs<BM, BN>(t.nwg);
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
      // Producer: one thread keeps up to S stages in flight.  Boxes wholly
      // past the last row or column are not loaded: their slot rows only
      // reach outputs past the matrix, which are never stored.
      if (threadIdx.x % 32 == 0) {
        constexpr int AROWS = BM == 16 ? 16 : ABOX;
        const CUtensorMap* mapa = BM == 16 ? m.a16 : m.a;
        const int abox = min(BM / AROWS, (g.m - t.orow + AROWS - 1) / AROWS);
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
                          t.ocol + 64 * h, t.batch);
            else
              tma_load_3d(b + 64 * ROWB * h, m.b, full, t.ocol + 64 * h,
                          p * BK, t.batch);
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
    finish_tile<BM, BN>(acc, t, consumer);
  }
};

// Route C: every thread loads pairs of neighbouring elements of the next
// stage into registers while the current one is multiplied, then writes
// them in the swizzled layouts TMA would have written.
struct LdRoute {
  template <int BM, int BN>
  static __device__ __forceinline__ void run(const Tile& t, const Maps&) {
    using namespace sm90;
    constexpr int THREADS = LD_WARPGROUPS * WG_THREADS;
    constexpr int PER = (BM + BN) * BK / 2 / THREADS;  // pairs a thread
    static_assert((BM + BN) * BK / 2 % THREADS == 0, "stage split");
    const GemmArgs& g = t.g;
    const unsigned short* A = reinterpret_cast<const unsigned short*>(g.a) +
                              (int64_t)t.batch * g.m * g.k;
    const unsigned short* B = reinterpret_cast<const unsigned short*>(g.b) +
                              (int64_t)t.batch * g.k * g.n;
    const uint32_t base = smem_u32(t.smem);
    const uint32_t stage = stage_bytes(LD_WARPGROUPS);
    const int wg = threadIdx.x / WG_THREADS;
    const bool consumer = wg < active_wgs<BM, BN>(LD_WARPGROUPS);
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
    finish_tile<BM, BN>(acc, t, consumer);
  }
};

template <typename T, int BM, int BN>
__device__ __forceinline__ void tile(const Tile& t, const Maps& m) {
  if constexpr (std::is_same<T, F32Route>::value)
    T::template run<BM, BN>(t);
  else
    T::template run<BM, BN>(t, m);
}

// The palette, in the order kernel.py's TEMPLATE_SHAPES lists it.  Each
// (route, shape) tile routine is compiled once and shared by both entry
// points.
__host__ __device__ inline int shape_bm(int shape) {
  return shape < 2 ? 16 : shape < 4 ? 64 : 128;
}
__host__ __device__ inline int shape_bn(int shape) {
  return shape % 2 ? 128 : 64;
}

template <typename T>
__device__ __forceinline__ void tile_by_shape(int shape, const Tile& t,
                                              const Maps& m) {
  switch (shape) {
    case 0: tile<T, 16, 64>(t, m); break;
    case 1: tile<T, 16, 128>(t, m); break;
    case 2: tile<T, 64, 64>(t, m); break;
    case 3: tile<T, 64, 128>(t, m); break;
    case 4: tile<T, 128, 64>(t, m); break;
    case 5: tile<T, 128, 128>(t, m); break;
    default: break;
  }
}

// The block's tile.  Fused: table row blockIdx.x / split, (row0, col0,
// row_end, col_end, rs, cs, block_id, scale_idx); the window sits at the
// clamped origin (rs, cs) and blocks[3 * block_id] names its shape.
// Region: window blockIdx.x / split of the region's grid, in bands of
// RASTER_ROWS tile rows, each band column by column.
// blockIdx.y is the batch; a cluster's blocks are consecutive in x.
__device__ __forceinline__ int resolve_tile(const TileSrc& src, Tile& t) {
  const int tile = blockIdx.x / src.split;
  t.batch = blockIdx.y;
  t.split = src.split;
  t.nwg = src.nwg;
  t.rank = src.split > 1 ? (int)sm90::cluster_rank() : 0;
  if (src.table) {
    const int* row = src.table + (int64_t)tile * 8;
    t.orow = row[4]; t.ocol = row[5];
    t.r0 = row[0]; t.r1 = row[2]; t.c0 = row[1]; t.c1 = row[3];
    return src.blocks[3 * row[6]];
  }
  const int bm = shape_bm(src.shape), bn = shape_bn(src.shape);
  const int band = tile / (RASTER_ROWS * src.tiles_c);
  const int rows = min(RASTER_ROWS, src.tiles_r - band * RASTER_ROWS);
  const int rem = tile - band * RASTER_ROWS * src.tiles_c;
  t.orow = src.row0 + (band * RASTER_ROWS + rem % rows) * bm;
  t.ocol = src.col0 + (rem / rows) * bn;
  t.r0 = t.orow; t.r1 = min(t.orow + bm, src.row0 + src.rows);
  t.c0 = t.ocol; t.c1 = min(t.ocol + bn, src.col0 + src.cols);
  return src.shape;
}

template <typename R>
__global__ void __launch_bounds__(2 * WG_THREADS + PRODUCER_THREADS, 2)
gemm_bf16_kernel(const __grid_constant__ CUtensorMap ma16,
                 const __grid_constant__ CUtensorMap ma,
                 const __grid_constant__ CUtensorMap mb,
                 const __grid_constant__ GemmArgs g, const TileSrc src) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  Tile t;
  t.g = g;
  const int shape = resolve_tile(src, t);
  const uint32_t raw = sm90::smem_u32(smem_raw);
  t.smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  tile_by_shape<R>(shape, t, Maps{&ma16, &ma, &mb});
}

template <typename R>
__global__ void __launch_bounds__(NT)
gemm_f32_kernel(const __grid_constant__ GemmArgs g, const TileSrc src) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  Tile t;
  t.g = g;
  t.smem = smem;
  const int shape = resolve_tile(src, t);
  tile_by_shape<R>(shape, t, Maps{nullptr, nullptr, nullptr});
}

// ---------------------------------------------------------------------------
// Host side: tensor maps, launch configuration.
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up through the CUDA runtime's entry-point
// query, so the library needs no -lcuda.
EncodeTiled encode_tiled() {
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
bool make_map(CUtensorMap* map, const void* ptr, uint64_t inner,
              uint64_t outer, uint64_t batch, uint32_t box0, uint32_t box1,
              CUtensorMapSwizzle swizzle) {
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

// Consumer warpgroups of a launch: two when a tile of bm 128 is in it
// (or on route C, which always runs two), else one.
int consumer_wgs(int route, int max_bm) {
  return route == ROUTE_C || max_bm > 64 ? 2 : 1;
}

template <typename R>
cudaError_t launch_bf16(const GemmArgs& g, const TileSrc& src, int tiles,
                        int nb, cudaStream_t s) {
  constexpr bool tma = std::is_same<R, TmaRoute>::value;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_bf16_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        tma ? ring_bytes(2) : LD_SMEM);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  CUtensorMap ma16{}, ma{}, mb{};
  if (tma) {
    // A (nb, m, k) and an "nt" B (nb, n, k): K-major boxes of BK x 16,
    // BK x ABOX and BK x 64; an "nn" B (nb, k, n): MN-major boxes of
    // 64 x BK.
    const CUtensorMapSwizzle kmajor =
        ROWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
    const bool ok =
        make_map(&ma16, g.a, g.k, g.m, nb, BK, 16, kmajor) &&
        make_map(&ma, g.a, g.k, g.m, nb, BK, ABOX, kmajor) &&
        (g.nt ? make_map(&mb, g.b, g.k, g.n, nb, BK, 64, kmajor)
              : make_map(&mb, g.b, g.n, g.k, nb, 64, BK,
                         CU_TENSOR_MAP_SWIZZLE_128B));
    if (!ok) return cudaErrorInvalidValue;
  } else if (src.split != 1) {
    return cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * src.split, nb, 1);
  cfg.blockDim = dim3(src.nwg * WG_THREADS + (tma ? PRODUCER_THREADS : 0));
  cfg.dynamicSmemBytes = tma ? ring_bytes(src.nwg) : LD_SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  if (src.split > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = src.split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  const cudaError_t e = cudaLaunchKernelEx(&cfg, gemm_bf16_kernel<R>, ma16,
                                           ma, mb, g, src);
  return e != cudaSuccess ? e : cudaGetLastError();
}

cudaError_t launch(const GemmArgs& g, const TileSrc& src, int in_dtype,
                   int route, int tiles, int nb, cudaStream_t s) {
  if (tiles <= 0 || src.split < 1 || src.split > MAX_CLUSTER)
    return cudaErrorInvalidValue;
  if (in_dtype == DT_F32) {
    if (src.split != 1) return cudaErrorInvalidValue;
    gemm_f32_kernel<F32Route><<<dim3(tiles, nb), NT, 0, s>>>(g, src);
    return cudaGetLastError();
  }
  if (in_dtype != DT_BF16) return cudaErrorInvalidValue;
  if (route == ROUTE_C) return launch_bf16<LdRoute>(g, src, tiles, nb, s);
  if (route == ROUTE_A || route == ROUTE_B)
    return launch_bf16<TmaRoute>(g, src, tiles, nb, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// route: ROUTE_A / ROUTE_B (TMA ring) or ROUTE_C (loads through registers)
// for bf16, ignored for fp32; split: blocks a tile's K is split over (a
// cluster, 1 for none); max_bm: the largest template bm in the table.
extern "C" int gemm_fused(const void* a, const void* b, const void* bias,
                          const void* c, void* out, const int* table,
                          const int* blocks, int num_tiles, int nb, int m,
                          int n, int k, int nt, int in_dtype, int bias_dtype,
                          int c_dtype, int out_dtype, int epi, int route,
                          int split, int max_bm, void* stream) {
  GemmArgs g{a, b, bias, c, out, m, n, k, nt, bias_dtype, c_dtype, out_dtype,
             epi};
  TileSrc src{table, blocks, 0, 0, 0, 0, 0, 1, 1, split,
              consumer_wgs(route, max_bm)};
  return launch(g, src, in_dtype, route, num_tiles, nb,
                static_cast<cudaStream_t>(stream));
}

extern "C" int gemm_region(const void* a, const void* b, const void* bias,
                           const void* c, void* out, int row0, int col0,
                           int rows, int cols, int bm, int bn, int nb, int m,
                           int n, int k, int nt, int in_dtype, int bias_dtype,
                           int c_dtype, int out_dtype, int epi, int route,
                           int split, void* stream) {
  GemmArgs g{a, b, bias, c, out, m, n, k, nt, bias_dtype, c_dtype, out_dtype,
             epi};
  for (int shape = 0; shape < 6; ++shape) {
    if (shape_bm(shape) != bm || shape_bn(shape) != bn) continue;
    const int tiles_r = (rows + bm - 1) / bm, tiles_c = (cols + bn - 1) / bn;
    TileSrc src{nullptr, nullptr, shape, row0, col0, rows, cols, tiles_r,
                tiles_c, split, consumer_wgs(route, bm)};
    return launch(g, src, in_dtype, route, tiles_r * tiles_c, nb,
                  static_cast<cudaStream_t>(stream));
  }
  return cudaErrorInvalidValue;
}
