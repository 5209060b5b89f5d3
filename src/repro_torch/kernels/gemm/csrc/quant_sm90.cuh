// The quantized wgmma tile of Hopper (sm_90a), shared by the quantized
// planned GEMM (gemm_quant.cu) and the quantized grouped GEMM
// (../../grouped_gemm/csrc/grouped_quant.cu): their routes A and B.  Route
// C (operands TMA cannot read) and the fp32 route keep quant_tile.cuh's
// tiles.
//
// The ring is wgmma_tile.cuh's, with a conversion step between the TMA
// load and the products: one producer warp keeps QSTAGES stages of one K
// panel in flight (3-D tensor maps with logical extents, so TMA's zero
// fill masks every edge), and the consumer warpgroups turn each arrived
// stage into the panels the wgmma descriptors read, then multiply.  By the
// staged pair (A's wire type, B's):
//   * int8 x int8: int8 wgmma (m64nNk32, int32 sums, exact) on 64-deep K
//     panels whose rows are 64 bytes, the byte layout of the bf16 panels.
//     The PTX ISA reads 8-bit operands K-major only.  A, and an "nt" B
//     (n, k), arrive K-major by TMA in the 64-byte swizzle; an "nn" B (k,
//     n), and the grouped bank (E, K, N), arrive N-major, a window of 128
//     columns in rows of 128 bytes, and are re-laid into the K-major
//     panel with byte permutes, 4 x 4 bytes a thread, spread so that no
//     warp's load or store meets a bank conflict.
//   * bf16 A with an int8 / e4m3 B (W8A16), e4m3 x e4m3: bf16 wgmma with
//     fp32 sums on 32-deep panels, exactly as the wide tile; each 8-bit
//     operand is widened to bf16 after its load (exact: int8 needs 7
//     mantissa bits, e4m3 3, and both exponent ranges fit bf16's) into the
//     layout TMA writes for the wide kernels: K-major 64-byte-swizzled rows
//     (A, an "nt" B) or the MN-major 128-byte-swizzled 64-column chunks
//     that desc_mn128 reads (an "nn" B).  The wide tile's panel_mma then
//     runs unchanged.  The native e4m3 wgmma is not used: it sums with
//     reduced precision over long K.
// A stage's conversion writes its own compute slots, which the stage's
// previous products finished with before the stage was refilled; a named
// barrier over the consumer warpgroups then orders every thread's writes
// before any warpgroup's products.  Every consumer warpgroup converts,
// also one whose rows the tile does not hold (a 32-row decode group on a
// 128-row tile), so the conversion takes half the time there.
//
// Tiles: bm >= 64 (route A): one consumer warpgroup per 64-row A box that
// reaches into the tile's live rows (row-aware, as wgmma_tile.cuh); bm 16
// (route B): swap-AB, the weight columns are wgmma's 64 rows and the <= 16
// activation rows its N.  Where a plan has fewer tiles than the card has
// SMs, K is split over a cluster: partial sums reach the leader through
// distributed shared memory in rank order (int32 for int8, so the sum
// stays exact), and the leader alone stores.
//
// The epilogue stages the finished fp32 tile in the ring and stores rows of
// eight owned columns with 16-byte stores: dequant (sa[row] * sb[col], or
// sb alone), + bias, activation (gelu is the tanh approximation), the cast.
// A thread's eight columns are fixed, so it loads their scales and bias
// once a tile, and each row's scale once a row.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>
#include <type_traits>

#include "gemm_sm90.cuh"
#include "wgmma_tile.cuh"

namespace qwg {

using wgt::ABOX;
using wgt::PRODUCER_THREADS;
using wgt::WG_THREADS;

constexpr int QSTAGES = 4;  // two blocks an SM at every pair's largest stage
constexpr int ROWB = wgt::ROWB;  // 64-byte rows of every compute panel
static_assert(ROWB == 64, "the compute panels are the wide tile's");
constexpr int B_COLS = 128;      // the widest B window
constexpr int B_SLOT = B_COLS * ROWB;

// The staged pair: A's wire type TA, B's TB (int8 or e4m3).
template <typename TA, typename TB>
struct Pair {
  static constexpr bool S8 = std::is_same<TA, signed char>::value;
  static constexpr bool A_WIDEN = std::is_same<TA, __nv_fp8_e4m3>::value;
  static_assert(!S8 || std::is_same<TB, signed char>::value, "int8 x int8");
  // K elements a stage: 64 bytes of int8, or 32 bf16 (64 bytes widened).
  static constexpr int BK = S8 ? 64 : 32;
  // Bytes of one loaded A row and of one 64-column B box as it arrives.
  static constexpr int A_ROWB = A_WIDEN ? 32 : 64;
  static constexpr int B_BOX = BK * 64;
  // A stage: A's compute slot, A's raw slot (e4m3 only), B's compute slot,
  // B's raw slot; each a multiple of 1024 bytes.
  __host__ __device__ static constexpr int a_slot(int nwg) {
    return nwg * 64 * ROWB;
  }
  __host__ __device__ static constexpr int a_raw(int nwg) {
    return A_WIDEN ? nwg * 64 * A_ROWB : 0;
  }
  static constexpr int B_RAW = 2 * B_BOX;
  __host__ __device__ static constexpr int stage_bytes(int nwg) {
    return a_slot(nwg) + a_raw(nwg) + B_SLOT + B_RAW;
  }
  __host__ __device__ static constexpr int ring_bytes(int nwg) {
    return 1024 + QSTAGES * stage_bytes(nwg) + 2 * QSTAGES * 8;
  }
};

template <typename TA, typename TB>
constexpr bool ring_fits() {
  using P = Pair<TA, TB>;
  return 2 * P::ring_bytes(2) <= 232448 &&  // two blocks an SM
         QSTAGES * P::stage_bytes(2) >= wgt::STAGED_TILE_BYTES &&
         QSTAGES * P::stage_bytes(1) >= 64 * (128 + 4) * 4;
}
static_assert(ring_fits<__nv_bfloat16, signed char>() &&
                  ring_fits<__nv_bfloat16, __nv_fp8_e4m3>() &&
                  ring_fits<signed char, signed char>() &&
                  ring_fits<__nv_fp8_e4m3, __nv_fp8_e4m3>(),
              "the ring, its staged tile and the split partials fit");

// The tensor maps of a call: A in boxes of 16 rows (bm 16) and of ABOX
// rows; B in boxes of 64 columns, and an "nn" B also in boxes of 128
// columns (a window of 128 columns then arrives in rows of 128 bytes).
struct QMaps {
  const CUtensorMap* a16;
  const CUtensorMap* a;
  const CUtensorMap* b;
  const CUtensorMap* b128;
};

// int32 accumulators of an int8 tile, shaped as wgmma_tile.cuh's Acc.
template <int BM, int BN>
struct AccI {
  static constexpr int N = wgt::Acc<BM, BN>::N;
  int d[N];
};

// What the epilogue needs besides the accumulator.  sb, bias: the tile's
// matrix's column vectors (the grouped GEMM offsets them to the expert's
// row); sa: the row scales indexed by output row, or null (W8A16).
struct QArgs {
  const float* sa;
  const float* sb;
  const void* bias;
  void* out;
  int m, n, k;  // A's rows (its map's extent), columns, reduction
  int nt;       // 1: B is (n, k); 0: B is (k, n)
  int bias_dtype, out_dtype, epi;
};

// One block's tile: the window at (orow, ocol), the owned rectangle
// [r0, r1) x [c0, c1), B's batch (the grouped GEMM's expert), the window's
// rows from orow that may be owned, the split-K rank and cluster size, and
// the launch's consumer warpgroups.
struct QTile {
  QArgs g;
  int orow, ocol, r0, r1, c0, c1;
  int bbatch, live, rank, split, nwg;
  unsigned char* smem;
};

template <int BM, int BN>
__device__ __forceinline__ int active_wgs(const QTile& t) {
  return BM == 16 ? min(t.nwg, BN / 64) : min(BM / 64, (t.live + 63) / 64);
}

// ---- widening and re-laying -------------------------------------------------

// Eight 8-bit values to eight bf16 (exact), as one 16-byte chunk.
__device__ __forceinline__ uint4 widen8(uint2 raw, signed char) {
  const signed char* b = reinterpret_cast<const signed char*>(&raw);
  uint4 out;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(static_cast<float>(b[2 * i]),
                                 static_cast<float>(b[2 * i + 1]));
  return out;
}

__device__ __forceinline__ uint4 widen8(uint2 raw, __nv_fp8_e4m3) {
  const __nv_fp8x2_storage_t* p =
      reinterpret_cast<const __nv_fp8x2_storage_t*>(&raw);
  uint4 out;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __half2_raw hr = __nv_cvt_fp8x2_to_halfraw2(p[i], __NV_E4M3);
    const float2 f = __half22float2(__half2(hr));
    h[i] = __floats2bfloat162_rn(f.x, f.y);
  }
  return out;
}

// The byte offset of 16-byte chunk c of row r in a K-major panel of 64-byte
// rows in the 64-byte swizzle (what TMA writes and desc_k64 reads).
__device__ __forceinline__ uint32_t kmajor_off(int r, int c) {
  return r * ROWB + ((c ^ ((r >> 1) & 3)) << 4);
}

// One stage's conversion by the ct-th of nthr consumer threads: A's e4m3
// rows widened (arows rows), then B's window (BN columns) widened or
// re-laid; an int8 "nt" B arrived in place.  An "nt" B arrives in boxes of
// 64 rows of BK bytes, an "nn" B in rows of BN bytes (one box).
template <typename TA, typename TB, int BN>
__device__ __forceinline__ void convert(unsigned char* a,
                                        const unsigned char* a_raw, int arows,
                                        unsigned char* b,
                                        const unsigned char* b_raw, int nt,
                                        int ct, int nthr) {
  using P = Pair<TA, TB>;
  if constexpr (P::A_WIDEN) {
    for (int u = ct; u < arows * 4; u += nthr) {
      const int r = u / 4, c = u % 4;
      const uint2 raw =
          *reinterpret_cast<const uint2*>(a_raw + r * 32 + c * 8);
      *reinterpret_cast<uint4*>(a + kmajor_off(r, c)) = widen8(raw, TA());
    }
  }
  constexpr int UNITS = BN / 64 * 256;  // 256 units a 64-column chunk
  if constexpr (P::S8) {
    if (nt) return;
    // (k, n) -> rows of n, 64 bytes of k: a 4 x 4 byte transpose a unit
    // (k0..k0+3, n0..n0+3), its bytes moved by permutes.  The units are
    // spread over a warp so that none of its loads or stores meets a bank
    // conflict: a 128-column window arrives in rows of 128 bytes, and a
    // warp's 32 units take its 32 column groups, each its own row group,
    // the odd ones storing their rows in swapped pairs; a 64-column window
    // arrives in rows of 64 bytes, and a warp's 32 units take 16 column
    // groups and 16 row groups, each once, its two half-warps loading their
    // rows and the odd column groups storing theirs in swapped pairs.
    for (int u = ct; u < UNITS; u += nthr) {
      const int nb = u % (BN / 4), n0 = 4 * nb;  // the unit's column group
      const int half = BN == 128 ? 0 : (u / 16) & 1;
      const int k0 = 4 * ((BN == 128 ? (nb >> 1) + u / 32
                                     : nb + half + 2 * (u / 32)) & 15);
      const unsigned char* src = b_raw + k0 * BN + n0;
      const int sw = BN * half;  // row pairs (0, 1), (2, 3) swapped
      const uint32_t x0 = *reinterpret_cast<const uint32_t*>(src + sw);
      const uint32_t x1 = *reinterpret_cast<const uint32_t*>(src + (BN ^ sw));
      const uint32_t x2 =
          *reinterpret_cast<const uint32_t*>(src + ((2 * BN) ^ sw));
      const uint32_t x3 =
          *reinterpret_cast<const uint32_t*>(src + ((3 * BN) ^ sw));
      const uint32_t w0 = half ? x1 : x0, w1 = half ? x0 : x1;
      const uint32_t w2 = half ? x3 : x2, w3 = half ? x2 : x3;
      const uint32_t t0 = __byte_perm(w0, w1, 0x5140);
      const uint32_t t1 = __byte_perm(w0, w1, 0x7362);
      const uint32_t t2 = __byte_perm(w2, w3, 0x5140);
      const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
      const uint32_t o[4] = {__byte_perm(t0, t2, 0x5410),
                             __byte_perm(t0, t2, 0x7632),
                             __byte_perm(t1, t3, 0x5410),
                             __byte_perm(t1, t3, 0x7632)};
      const int odd = nb & 1;  // odd column groups store rows swapped
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = n0 + (j ^ odd);
        *reinterpret_cast<uint32_t*>(b + kmajor_off(r, k0 >> 4) + (k0 & 15)) =
            odd ? o[j ^ 1] : o[j];
      }
    }
  } else if (nt) {
    // (n, k): 64 rows of 32 bytes a box -> K-major rows of 32 bf16.
    for (int u = ct; u < UNITS; u += nthr) {
      const int h = u / 256, v = u % 256, j = v / 4, c = v % 4;
      const uint2 raw = *reinterpret_cast<const uint2*>(
          b_raw + h * P::B_BOX + j * 32 + c * 8);
      *reinterpret_cast<uint4*>(b + kmajor_off(h * 64 + j, c)) =
          widen8(raw, TB());
    }
  } else {
    // (k, n): 32 rows of BN bytes -> 64-column chunks of 32 rows of 128
    // bytes in the 128-byte swizzle.
    constexpr int GROUPS = BN / 8;  // 8-byte groups a raw row
    for (int u = ct; u < UNITS; u += nthr) {
      const int kk = u / GROUPS, cq = u % GROUPS;
      const uint2 raw =
          *reinterpret_cast<const uint2*>(b_raw + kk * BN + cq * 8);
      *reinterpret_cast<uint4*>(b + (cq >> 3) * (32 * 128) + kk * 128 +
                                (((cq & 7) ^ (kk & 7)) << 4)) =
          widen8(raw, TB());
    }
  }
}

// ---- products ---------------------------------------------------------------

// One int8 stage's products: two k-steps of 32; A and B K-major.
template <int BM, int BN>
__device__ __forceinline__ void panel_mma_s8(AccI<BM, BN>& acc, uint32_t a,
                                             uint32_t b, int wg, int nwg) {
  using namespace sm90;
  if constexpr (BM == 16) {
    constexpr int HALVES = BN / 64;
#pragma unroll
    for (int hh = 0; hh < HALVES; ++hh) {
      const int h = wg + hh * nwg;
      if (h >= HALVES) continue;
      const uint32_t w = b + h * 64 * ROWB;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        wgmma_s8_n16(acc.d + 8 * hh, desc_k64(w + ks * 32),
                     desc_k64(a + ks * 32));
    }
  } else {
    const uint32_t arow = a + wg * 64 * ROWB;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      if constexpr (BN == 64)
        wgmma_s8_n64(acc.d, desc_k64(arow + ks * 32), desc_k64(b + ks * 32));
      else
        wgmma_s8_n128(acc.d, desc_k64(arow + ks * 32), desc_k64(b + ks * 32));
    }
  }
}

// ---- split-K reduction and epilogue -----------------------------------------

__device__ __forceinline__ float ld_remote(uint32_t addr, float) {
  return sm90::ld_dsmem(addr);
}
__device__ __forceinline__ int ld_remote(uint32_t addr, int) {
  return sm90::ld_dsmem_s32(addr);
}

// The split-K reduction (partial sums, in the accumulator's type, into the
// cluster leader in rank order) and the dequant epilogue from the staged
// fp32 tile.  Every thread of the block calls it: the cluster barriers
// count them all.
template <int BM, int BN, class Acc>
__device__ __forceinline__ void finish(Acc& acc, const QTile& t,
                                       bool consumer) {
  using namespace sm90;
  using V = typename std::remove_reference<decltype(acc.d[0])>::type;
  constexpr int N = Acc::N;
  constexpr int HALVES = BN / 64;
  const int wg = threadIdx.x / WG_THREADS;
  const int nwg_act = active_wgs<BM, BN>(t);
  const int nact = WG_THREADS * nwg_act;
  const int ct = threadIdx.x;  // consumer thread index, < nact
  __syncwarp();  // the cluster barrier is .aligned
  if (t.split > 1) {
    if (consumer) {
      bar_sync(1, nact);  // every consumer's products are done
      fence_proxy_async();
      if (t.rank != 0) {
        V* red = reinterpret_cast<V*>(t.smem);
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
          acc.d[i] += ld_remote(remote + 4u * (uint32_t)(i * nact + ct), V());
      }
    }
    cluster_sync();  // the peers' buffers stay alive until read
  }
  if (!consumer || t.rank != 0) return;
  constexpr int LD = BN + 4;
  float* st = reinterpret_cast<float*>(t.smem);
  if (t.split == 1) {
    bar_sync(1, nact);
    fence_proxy_async();
  }
  const int lane = threadIdx.x % 32, w = (threadIdx.x / 32) % 4;
  const int qr = 16 * w + lane / 4, qc = 2 * (lane % 4);
  if constexpr (BM == 16) {
    // C^T fragments: rows are weight columns, columns are activation rows.
#pragma unroll
    for (int hh = 0; hh < HALVES; ++hh) {
      const int h = wg + hh * t.nwg;
      if (h >= HALVES) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            st[(8 * j + qc + c) * LD + 64 * h + qr + 8 * i] =
                static_cast<float>(acc.d[8 * hh + 4 * j + 2 * i + c]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(st + (64 * wg + qr + 8 * i) * LD + 8 * j +
                                   qc) =
            make_float2(static_cast<float>(acc.d[4 * j + 2 * i]),
                        static_cast<float>(acc.d[4 * j + 2 * i + 1]));
  }
  // A thread's eight columns are the same in every row it stores (nact is a
  // multiple of BN / 8): their column scales and bias are loaded once.
  const QArgs& g = t.g;
  const int lc = ct % (BN / 8) * 8, cbase = t.ocol + lc;
  const bool bias = wgt::has_bias(g.epi);
  float sbv[8] = {}, bv[8] = {};
  if (cbase < g.n) {
    const int nv = min(g.n - cbase, 8);
    wgt::load8(g.sb, wgt::DT_F32, cbase, nv, sbv);
    if (bias) wgt::load8(g.bias, g.bias_dtype, cbase, nv, bv);
  }
  bar_sync(1, nact);

  const int staged = BM == 16 ? BM : 64 * nwg_act;
  for (int q = ct; q < staged * BN / 8; q += nact) {
    const int lr = q / (BN / 8);
    const int r = t.orow + lr;
    if (r < t.r0 || r >= t.r1) continue;
    const int lo = max(t.c0 - cbase, 0), hi = min(t.c1 - cbase, 8);
    if (lo >= hi) continue;
    float v[8];
    const float4 x0 = *reinterpret_cast<const float4*>(st + lr * LD + lc);
    const float4 x1 = *reinterpret_cast<const float4*>(st + lr * LD + lc + 4);
    v[0] = x0.x; v[1] = x0.y; v[2] = x0.z; v[3] = x0.w;
    v[4] = x1.x; v[5] = x1.y; v[6] = x1.z; v[7] = x1.w;
    const float sar = g.sa ? g.sa[r] : 1.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float x = v[e] * (sar * sbv[e]);
      if (bias) x += bv[e];
      v[e] = wgt::activate(x, g.epi);
    }
    wgt::store8(g.out, g.out_dtype, (int64_t)r * g.n + cbase, lo, hi, v);
  }
}

// ---- the ring ---------------------------------------------------------------

// Routes A and B of a staged pair.  Block = nwg consumer warpgroups and the
// producer warp (the last).  Each block sums the panels [p0, p1) of its
// split-K share.
template <typename TA, typename TB>
struct Ring {
  using P = Pair<TA, TB>;

  template <int BM, int BN>
  static __device__ __forceinline__ void run(const QTile& t,
                                             const QMaps& m) {
    using namespace sm90;
    using Acc = typename std::conditional<P::S8, AccI<BM, BN>,
                                          wgt::Acc<BM, BN>>::type;
    const QArgs& g = t.g;
    const int steps = (g.k + P::BK - 1) / P::BK;
    const int p0 = (int)((int64_t)t.rank * steps / t.split);
    const int p1 = (int)((int64_t)(t.rank + 1) * steps / t.split);
    constexpr int S = QSTAGES;
    const uint32_t base = smem_u32(t.smem);
    const uint32_t stage = P::stage_bytes(t.nwg);
    const uint32_t a_off = 0, a_raw_off = P::a_slot(t.nwg);
    const uint32_t b_off = a_raw_off + P::a_raw(t.nwg);
    const uint32_t b_raw_off = b_off + B_SLOT;
    const uint32_t bars = base + S * stage;  // full[s], then empty[s]
    const int wg = threadIdx.x / WG_THREADS;
    const int nact = active_wgs<BM, BN>(t);
    // An int8 "nt" B arrives K-major in its compute slot; every other B,
    // and an e4m3 A, is converted.
    const bool b_direct = P::S8 && g.nt;
    const bool converts = P::A_WIDEN || !b_direct;
    if (threadIdx.x == 0) {
      for (int s = 0; s < S; ++s) {
        mbar_init(bars + 8 * s, 1);
        mbar_init(bars + 8 * (S + s), 4 * nact);
      }
      mbar_init_fence();
    }
    __syncthreads();

    Acc acc;
#pragma unroll
    for (int i = 0; i < Acc::N; ++i) acc.d[i] = 0;
    const bool consumer = wg < nact;
    constexpr int AROWS = BM == 16 ? 16 : ABOX;
    if (wg == t.nwg) {
      // Producer: one thread keeps up to S stages in flight.  A boxes wholly
      // past the last row or the live rows, and B boxes wholly past the
      // last column, are not loaded: their slot rows only reach outputs
      // that are never stored.
      if (threadIdx.x % 32 == 0) {
        const CUtensorMap* mapa = BM == 16 ? m.a16 : m.a;
        const int arows = min(g.m - t.orow, t.live);
        const int abox = min(BM / AROWS, (arows + AROWS - 1) / AROWS);
        // An "nn" B comes in one box of BN columns; an "nt" B in 64-row
        // boxes, those wholly past the last column left out.
        const int bbox =
            g.nt ? min(BN / 64, (g.n - t.ocol + 63) / 64) : 1;
        const uint32_t bytes = abox * AROWS * P::A_ROWB +
                               (g.nt ? bbox * P::B_BOX : BN * P::BK);
        const CUtensorMap* mapb = g.nt || BN == 64 ? m.b : m.b128;
        const uint32_t a_dst = P::A_WIDEN ? a_raw_off : a_off;
        const uint32_t b_dst = b_direct ? b_off : b_raw_off;
        int s = 0;
        uint32_t phase = 0;
        for (int p = p0; p < p1; ++p) {
          mbar_wait(bars + 8 * (S + s), phase ^ 1);
          const uint32_t full = bars + 8 * s;
          const uint32_t st = base + s * stage;
          mbar_expect_tx(full, bytes);
          for (int i = 0; i < abox; ++i)
            tma_load_3d(st + a_dst + AROWS * P::A_ROWB * i, mapa, full,
                        p * P::BK, t.orow + AROWS * i, 0);
          for (int h = 0; h < bbox; ++h) {
            if (g.nt)
              tma_load_3d(st + b_dst + P::B_BOX * h, mapb, full, p * P::BK,
                          t.ocol + 64 * h, t.bbatch);
            else
              tma_load_3d(st + b_dst, mapb, full, t.ocol, p * P::BK,
                          t.bbatch);
          }
          if (++s == S) { s = 0; phase ^= 1; }
        }
      }
    } else if (consumer || converts) {
      // Every consumer warpgroup converts, those without products too (a
      // 32-row group on a 128-row tile); only those with rows multiply.
      const int arows = BM == 16 ? 16 : 64 * nact;
      int s = 0, prev = -1;
      uint32_t phase = 0;
      for (int p = p0; p < p1; ++p) {
        mbar_wait(bars + 8 * s, phase);
        unsigned char* st = t.smem + s * stage;
        if (converts) {
          convert<TA, TB, BN>(st + a_off, st + a_raw_off, arows, st + b_off,
                              st + b_raw_off, g.nt, threadIdx.x,
                              WG_THREADS * t.nwg);
          fence_proxy_async();
          bar_sync(2, WG_THREADS * t.nwg);
        }
        if (!consumer) {
          if (++s == S) { s = 0; phase ^= 1; }
          continue;
        }
        __syncwarp();  // wgmma is .aligned: the warp reconverges first
        const uint32_t a = base + s * stage + a_off;
        const uint32_t b = base + s * stage + b_off;
        fence_regs(acc.d);
        wgmma_fence();
        if constexpr (P::S8)
          panel_mma_s8<BM, BN>(acc, a, b, wg, t.nwg);
        else
          wgt::panel_mma<BM, BN>(acc, a, b, wg, t.nwg, g.nt);
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
    finish<BM, BN>(acc, t, consumer);
  }
};

// The (bm, bn) palette on the ring, in the order of the wide kernels'
// (gemm/kernel.py's TEMPLATE_SHAPES, grouped_gemm/kernel.py's SHAPES), so
// the same plans and tile tables drive both entry points.
template <typename R>
__device__ __forceinline__ void run_by_shape(int shape, const QTile& t,
                                             const QMaps& m) {
  switch (shape) {
    case 0: R::template run<16, 64>(t, m); break;
    case 1: R::template run<16, 128>(t, m); break;
    case 2: R::template run<64, 64>(t, m); break;
    case 3: R::template run<64, 128>(t, m); break;
    case 4: R::template run<128, 64>(t, m); break;
    case 5: R::template run<128, 128>(t, m); break;
    default: break;
  }
}

// ---------------------------------------------------------------------------
// Host side: the tensor maps of a call.
// ---------------------------------------------------------------------------

// A 3-D map of bytes (int8 or e4m3) over (inner, outer, batch) with a
// (box0, box1, 1) box; TMA fills zeros past the logical extents.
inline bool make_map8(CUtensorMap* map, const void* ptr, uint64_t inner,
                      uint64_t outer, uint64_t batch, uint32_t box0,
                      uint32_t box1, CUtensorMapSwizzle swizzle) {
  wgt::EncodeTiled encode = wgt::encode_tiled();
  if (!encode || reinterpret_cast<uintptr_t>(ptr) % 16 || inner % 16)
    return false;
  const cuuint64_t dims[3] = {inner, outer, batch};
  const cuuint64_t strides[2] = {inner, inner * outer};
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A's maps: (k, rows) in boxes of 16 rows (bm 16) and of ABOX rows, one
// K panel deep: bf16 and int8 K-major in the 64-byte swizzle, e4m3 raw.
template <typename TA, typename TB>
bool make_a_maps(CUtensorMap* a16, CUtensorMap* a, const void* ptr, int k,
                 int rows) {
  using P = Pair<TA, TB>;
  if constexpr (std::is_same<TA, __nv_bfloat16>::value)
    return wgt::make_map(a16, ptr, k, rows, 1, P::BK, 16,
                         CU_TENSOR_MAP_SWIZZLE_64B) &&
           wgt::make_map(a, ptr, k, rows, 1, P::BK, ABOX,
                         CU_TENSOR_MAP_SWIZZLE_64B);
  const CUtensorMapSwizzle sw =
      P::A_WIDEN ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_64B;
  return make_map8(a16, ptr, k, rows, 1, P::BK, 16, sw) &&
         make_map8(a, ptr, k, rows, 1, P::BK, ABOX, sw);
}

// B's maps over (batch, k, n) ("nn", the grouped bank) or (batch, n, k)
// ("nt"), one K panel deep: an "nt" B in boxes of 64 rows, K-major in the
// 64-byte swizzle for int8 (its compute layout), raw otherwise; an "nn" B
// raw, in boxes of 64 columns and of 128 (b128).
template <typename TA, typename TB>
bool make_b_maps(CUtensorMap* b, CUtensorMap* b128, const void* ptr, int k,
                 int n, int batch, int nt) {
  using P = Pair<TA, TB>;
  if (nt)
    return make_map8(b, ptr, k, n, batch, P::BK, 64,
                     P::S8 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_NONE);
  return make_map8(b, ptr, n, k, batch, 64, P::BK,
                   CU_TENSOR_MAP_SWIZZLE_NONE) &&
         make_map8(b128, ptr, n, k, batch, 128, P::BK,
                   CU_TENSOR_MAP_SWIZZLE_NONE);
}

}  // namespace qwg
