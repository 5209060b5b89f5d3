// Flash-attention backward for Hopper (sm_90a): dQ, dK, dV of
// o = softmax(q k^T * d^-0.5) v over (BH, s, d) operands, causal or not,
// from q, k, v, o, dO and the forward's log-sum-exp rows.
//
// Replaces the reference package's TPU backward kernel
// (src/repro/kernels/flash_attention/kernel.py, build_fused_flash_bwd_kernel
// / _fused_flash_bwd_kernel).  The math is the reference's, per visited
// (q-block, k-block) tile of the forward's FlashTileSchedule:
//
//   D  = rowsum(dO . O)                      (fp32, per window row)
//   P  = exp(q k^T * scale - lse)            where valid, else 0
//   dV += P^T dO;  dS = P (dO V^T - D) scale where valid, else 0
//   dK += dS^T Q;  dQ += dS K
//
// with valid = q rows in [q0, q_end), k columns in [k0, k_end), and
// kpos <= qpos when causal -- both axes owned, selected with `where`
// (never by multiplying), so clamped-window overlap contributes zero.
//
// The walk is not the reference's.  The TPU kernel walks the table
// q-block-major in one sequential grid and read-modify-writes dK/dV on
// whole-staged outputs.  Here thread blocks run in parallel, so the grid is
// (k-block, batch-head): each block walks the table rows that touch its
// k-block (FlashTileSchedule.k_block_index, CSR), keeps its k/v window and
// fp32 dK/dV accumulators for the whole walk, and stores only the rows
// [k0, k_end) it owns -- no two blocks own a dK/dV row, so those stores
// need no atomics.  A k-block no query reaches (causal, sk > sq) stores
// zeros.  D is recomputed per tile from the dO and O windows, in place of
// the reference's first-tile scratch.  dQ rows are shared between
// k-blocks: each block atomically adds its dS K into the owned rows of a
// caller-zeroed fp32 (BH, sq, d) buffer, so dQ's sum order changes from run
// to run (fp32 rounding differences only).
//
// What bounds it on the H100 at the training shape (BH = 128 = batch 8 x 16
// heads, sq = sk = 128, d = 128, causal, bf16): 0.34 GFLOP of useful work
// against 42 MB of operands and gradients (dK/dV in fp32), ~8 flop/byte,
// below the ~295 flop/byte ridge: bytes bound it (12.5 us at 3.35 TB/s).
// The routes (chosen per call in kernel.py, which counts them):
//   (A) bf16 operands TMA can read (16-byte aligned bases of q, k, v, o and
//       dO, rows of 2d bytes a multiple of 16): one consumer warpgroup holds
//       a 64-key block, keys in wgmma's M, and a producer warp loads K and V
//       once and keeps a ring of STAGES (Q, dO, O) windows in flight by TMA,
//       completed on mbarriers.  Every window is staged once, as K-major
//       panels of 32 columns in the 64-byte swizzle (3-D tensor maps over
//       (BH, s, d) with each head's own extent, so TMA zero-fills rows past
//       a head's end and columns past d), and read both ways: K-major where
//       d is the product's depth, MN-major (desc_mn64) where rows are.
//       The five products, all m64nNk16 bf16 wgmma with fp32 sums:
//         S^T  = K Q^T     A K,    B Q   (K-major)
//         dP^T = V dO^T    A V,    B dO  (K-major)
//         dV  += P^T dO    A P^T   (K-major), B dO (MN-major)
//         dK  += dS^T Q    A dS^T  (K-major), B Q  (MN-major)
//         dQ   = dS K      A dS^T  (MN-major), B K (MN-major), 64 columns
//                          at a time, added to dQ by paired fp32 atomics
//       P and dS are fp32; one bf16 rounding would cost them 8 bits and
//       break the 1e-3 agreement with the fp32 plain version, so each is
//       written as two bf16 panels, hi = bf16(x) and lo = bf16(x - hi)
//       (about 2^-16 relative), and each of their products runs twice.
//       Q, K, V and dO are bf16 already and go in exactly.  The masks,
//       exp, the split and dS run on the accumulator registers; a thread's
//       columns are q rows, whose LSE and D are staged per tile in shared
//       memory (D from the staged dO and O while S^T and dP^T run).  dK
//       and dV stay in registers for the whole walk.  About 162 KB of
//       shared memory a block at d > 64 (one block an SM), about 98 KB at
//       d <= 64 (two).
//   (C) bf16 operands TMA cannot read, and fp32 operands (never TF32): the
//       simple design, every tile product in fp32 on CUDA cores from shared
//       memory (q, k, v and dO windows upcast on load, rows padded against
//       bank conflicts), 256 threads, one block per SM (210 KB at
//       64 x 64 x 128).
// The PTX building blocks are the dense GEMM's (gemm_sm90.cuh), the tensor
// map encoder is wgmma_tile.cuh's.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "../../gemm/csrc/gemm_sm90.cuh"
#include "../../gemm/csrc/wgmma_tile.cuh"

namespace {

constexpr int NT = 256;
constexpr int BQ_MAX = 64;
constexpr int BK_MAX = 64;
constexpr int D_MAX = 128;
constexpr int PAD = 1;  // floats of padding per staged row

enum { ROUTE_A = 0, ROUTE_C = 1 };

struct BwdArgs {
  const void* q;     // (BH, sq, d)
  const void* k;     // (BH, sk, d)
  const void* v;     // (BH, sk, d)
  const void* o;     // (BH, sq, d)
  const void* dout;  // (BH, sq, d)
  const float* lse;  // (BH, sq)
  float* dq;         // (BH, sq, d), zeroed by the caller
  float* dk;         // (BH, sk, d)
  float* dv;         // (BH, sk, d)
  const int* table;  // (tiles, 8): q0 q_end qs k0 k_end ks first last
  const int* koff;   // (k_blocks + 1): CSR offsets into krows
  const int* krows;  // (tiles): table rows of each k-block, ascending
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

// Shared-memory carve-up (floats): the k, v, q and dO windows (rows padded),
// the dK / dV accumulators, the P / dS tile (rows padded), and per q row D
// and the LSE.
struct Smem {
  float *k, *v, *q, *dout, *dk, *dv, *p, *drow, *lse;
  __device__ Smem(float* base, int bq, int bk, int d) {
    const int ld = d + PAD;
    k = base;
    v = k + bk * ld;
    q = v + bk * ld;
    dout = q + bq * ld;
    dk = dout + bq * ld;
    dv = dk + bk * d;
    p = dv + bk * d;
    drow = p + bq * (bk + PAD);
    lse = drow + bq;
  }
};

// Rows [row0, row0 + rows) of a (len, d) slice, upcast; zero past `len`.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          int row0, int rows, int len, int d) {
  for (int i = threadIdx.x; i < rows * d; i += NT) {
    const int r = i / d, c = i % d, gr = row0 + r;
    dst[r * ld + c] = gr < len ? to_f(src[(int64_t)gr * d + c]) : 0.f;
  }
}

__device__ __forceinline__ bool valid(const BwdArgs& f, int qpos, int kpos,
                                      int q0, int q_end, int k0, int k_end) {
  return qpos >= q0 && qpos < q_end && kpos >= k0 && kpos < k_end &&
         (!f.causal || kpos <= qpos);
}

template <typename T>
__global__ void __launch_bounds__(NT) flash_bwd_kernel(BwdArgs f) {
  extern __shared__ float smem[];
  const int bq = f.bq, bk = f.bk, d = f.d, ld = d + PAD, lp = bk + PAD;
  const Smem sm(smem, bq, bk, d);
  const int64_t bh = blockIdx.y;
  const T* Q = reinterpret_cast<const T*>(f.q) + bh * f.sq * d;
  const T* K = reinterpret_cast<const T*>(f.k) + bh * f.sk * d;
  const T* V = reinterpret_cast<const T*>(f.v) + bh * f.sk * d;
  const T* O = reinterpret_cast<const T*>(f.o) + bh * f.sq * d;
  const T* dO = reinterpret_cast<const T*>(f.dout) + bh * f.sq * d;
  const float* LSE = f.lse + bh * f.sq;
  float* dQ = f.dq + bh * f.sq * d;
  float* dK = f.dk + bh * f.sk * d;
  float* dV = f.dv + bh * f.sk * d;

  // This block's k-block, as flash_tile_schedule lays it out.
  const int kb = blockIdx.x;
  const int k0 = kb * bk, k_end = min(k0 + bk, f.sk), ks = min(k0, f.sk - bk);
  load_rows<T>(sm.k, ld, K, ks, bk, f.sk, d);
  load_rows<T>(sm.v, ld, V, ks, bk, f.sk, d);
  for (int i = threadIdx.x; i < bk * d; i += NT) {
    sm.dk[i] = 0.f;
    sm.dv[i] = 0.f;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int n = f.koff[kb]; n < f.koff[kb + 1]; ++n) {
    const int* row = f.table + (int64_t)f.krows[n] * 8;
    const int q0 = row[0], q_end = row[1], qs = row[2];
    __syncthreads();  // the previous tile's readers of q / dO / P are done
    load_rows<T>(sm.q, ld, Q, qs, bq, f.sq, d);
    load_rows<T>(sm.dout, ld, dO, qs, bq, f.sq, d);
    for (int r = threadIdx.x; r < bq; r += NT) sm.lse[r] = LSE[qs + r];
    __syncthreads();

    // D = rowsum(dO . O): one warp per window row.
    for (int r = warp; r < bq; r += NT / 32) {
      const T* orow = O + (int64_t)(qs + r) * d;
      float acc = 0.f;
      for (int c = lane; c < d; c += 32)
        acc = fmaf(sm.dout[r * ld + c], to_f(orow[c]), acc);
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) sm.drow[r] = acc;
    }
    // P = exp(q k^T * scale - lse) where valid, 0 elsewhere.
    for (int i = threadIdx.x; i < bq * bk; i += NT) {
      const int r = i / bk, j = i % bk;
      const float* qr = sm.q + r * ld;
      const float* kr = sm.k + j * ld;
      float dot = 0.f;
      for (int c = 0; c < d; ++c) dot = fmaf(qr[c], kr[c], dot);
      sm.p[r * lp + j] = valid(f, qs + r, ks + j, q0, q_end, k0, k_end)
                             ? expf(dot * f.scale - sm.lse[r])
                             : 0.f;
    }
    __syncthreads();

    // dV += P^T dO.
    for (int i = threadIdx.x; i < bk * d; i += NT) {
      const int j = i / d, c = i % d;
      float acc = 0.f;
      for (int r = 0; r < bq; ++r)
        acc = fmaf(sm.p[r * lp + j], sm.dout[r * ld + c], acc);
      sm.dv[i] += acc;
    }
    __syncthreads();  // P is overwritten by dS below

    // dS = P (dO V^T - D) * scale where valid, 0 elsewhere, in place of P
    // (each thread rewrites only the entries it reads).
    for (int i = threadIdx.x; i < bq * bk; i += NT) {
      const int r = i / bk, j = i % bk;
      const float* gr = sm.dout + r * ld;
      const float* vr = sm.v + j * ld;
      float dp = 0.f;
      for (int c = 0; c < d; ++c) dp = fmaf(gr[c], vr[c], dp);
      float* pij = sm.p + r * lp + j;
      *pij = valid(f, qs + r, ks + j, q0, q_end, k0, k_end)
                 ? *pij * (dp - sm.drow[r]) * f.scale
                 : 0.f;
    }
    __syncthreads();

    // dK += dS^T Q.
    for (int i = threadIdx.x; i < bk * d; i += NT) {
      const int j = i / d, c = i % d;
      float acc = 0.f;
      for (int r = 0; r < bq; ++r)
        acc = fmaf(sm.p[r * lp + j], sm.q[r * ld + c], acc);
      sm.dk[i] += acc;
    }
    // dQ += dS K, into the owned rows only.
    for (int i = threadIdx.x; i < bq * d; i += NT) {
      const int r = i / d, c = i % d, qpos = qs + r;
      if (qpos < q0 || qpos >= q_end) continue;
      float acc = 0.f;
      for (int j = 0; j < bk; ++j)
        acc = fmaf(sm.p[r * lp + j], sm.k[j * ld + c], acc);
      atomicAdd(dQ + (int64_t)qpos * d + c, acc);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < bk * d; i += NT) {
    const int j = i / d, c = i % d, kpos = ks + j;
    if (kpos >= k0 && kpos < k_end) {
      dK[(int64_t)kpos * d + c] = sm.dk[i];
      dV[(int64_t)kpos * d + c] = sm.dv[i];
    }
  }
}

size_t smem_bytes(int bq, int bk, int d) {
  const size_t ld = d + PAD;
  return sizeof(float) * (2 * (size_t)bk * ld + 2 * (size_t)bq * ld +
                          2 * (size_t)bk * d + (size_t)bq * (bk + PAD) +
                          2 * (size_t)bq);
}

// ---------------------------------------------------------------------------
// Route A: TMA-fed Q/dO/O ring, wgmma for all five tile products.
// ---------------------------------------------------------------------------

constexpr int WG_THREADS = 128;              // the consumer warpgroup
constexpr int TC_THREADS = WG_THREADS + 32;  // + the TMA producer warp
constexpr int STAGES = 2;                    // (Q, dO, O) windows in flight
// One TMA box: 64 rows of 64 bytes (32 bf16 columns, K-major, 64-byte
// swizzle), 4096 bytes on a 1024-byte boundary.
constexpr int BOX = 4096;
constexpr int T_BYTES = BQ_MAX * BK_MAX * 2;     // a bf16 P or dS panel pair
// Shared memory of a route-A block at head dim DN (64 or 128): 1024 bytes
// of alignment slack, the K and V windows, STAGES stages of Q, dO and O,
// the P and dS hi / lo panel pairs, the LSE and D of a tile's q rows, and
// the K/V barrier with a full and an empty barrier a stage.
template <int DN>
constexpr int tc_smem() {
  return 1024 + 2 * (DN / 32 * BOX) + STAGES * 3 * (DN / 32 * BOX) +
         4 * T_BYTES + 2 * BQ_MAX * 4 + 8 * (1 + 2 * STAGES);
}
constexpr int TC_SMEM = tc_smem<D_MAX>();
static_assert(TC_SMEM <= 232448, "a route-A block fits the SM");
static_assert(2 * tc_smem<64>() <= 232448, "two d <= 64 blocks share an SM");

__device__ __forceinline__ unsigned char* align1024(unsigned char* raw) {
  const uint32_t a = sm90::smem_u32(raw);
  return raw + (((a + 1023) & ~1023u) - a);
}

template <int DN, int TA, int TB>
__device__ __forceinline__ void wgmma_nd(float* d, uint64_t da, uint64_t db) {
  if constexpr (DN == 128)
    sm90::wgmma_n128<TA, TB>(d, da, db);
  else
    sm90::wgmma_n64<TA, TB>(d, da, db);
}

// The dot product of two 16-byte runs of 8 bf16.
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), w = __bfloat1622float2(y[i]);
    acc = fmaf(u.x, w.x, fmaf(u.y, w.y, acc));
  }
  return acc;
}

// Two fp32 values as hi = bf16(x) and lo = bf16(x - hi), each a bf16 pair.
__device__ __forceinline__ void store_split(unsigned char* hi,
                                            unsigned char* lo, float x0,
                                            float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  *reinterpret_cast<__nv_bfloat162*>(hi) = h;
  *reinterpret_cast<__nv_bfloat162*>(lo) =
      __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
}

// dst[0] += x0 and dst[1] += x1 as one vector atomic (sm_90): half the
// atomic instructions of two scalar adds.
__device__ __forceinline__ void red_add2(float* dst, float x0, float x1) {
  asm volatile("red.global.add.v2.f32 [%0], {%1, %2};\n" ::"l"(dst),
               "f"(x0), "f"(x1)
               : "memory");
}

// Writes a thread's 64 x 64 accumulator tile (register 4 j + 2 i + c:
// row r0 + 8 i, column 8 j + c0 + c) as its hi and lo panel pairs: K-major
// rows of 64 bytes, columns 0-31 in the first panel and 32-63 in the
// second, the 16-byte chunk index XORed with bits 1-2 of the row (the
// 64-byte swizzle the descriptors assume).
__device__ __forceinline__ void store_tile(unsigned char* hi, const float* x,
                                           int r0, int c0) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      const int off = (j / 4) * BOX + r * 64 +
                      (((j % 4) ^ ((r >> 1) & 3)) << 4) + c0 * 2;
      store_split(hi + off, hi + T_BYTES + off, x[4 * j + 2 * i],
                  x[4 * j + 2 * i + 1]);
    }
}

template <int DN>
__global__ void __launch_bounds__(TC_THREADS, DN == 64 ? 2 : 1)
flash_bwd_wgmma(const __grid_constant__ CUtensorMap mq,
                const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv,
                const __grid_constant__ CUtensorMap mo,
                const __grid_constant__ CUtensorMap mdo,
                const __grid_constant__ BwdArgs f) {
  using namespace sm90;
  constexpr int QP = DN / 32;  // 32-column panels of a window
  constexpr int W = QP * BOX;  // a window's bytes
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t k_s = base, v_s = k_s + W, ring = v_s + W;
  const uint32_t p_s = ring + STAGES * 3 * W;  // P hi, P lo, dS hi, dS lo
  const uint32_t ds_s = p_s + 2 * T_BYTES;
  float* lse_s = reinterpret_cast<float*>(smem + (p_s - base) + 4 * T_BYTES);
  float* d_s = lse_s + BQ_MAX;
  const uint32_t bars = p_s + 4 * T_BYTES + 2 * BQ_MAX * 4;  // kv, full, empty
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + STAGES + s); };

  const int kb = blockIdx.x, bh = blockIdx.y;
  const int k0 = kb * f.bk, k_end = min(k0 + f.bk, f.sk);
  const int ks = min(k0, f.sk - f.bk);
  const int n0 = f.koff[kb], n = f.koff[kb + 1] - n0;
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
    // Producer: K and V once, then each visited tile's Q, dO and O windows
    // into the next free stage, up to STAGES tiles ahead of the consumers.
    // A block with no tile loads nothing.
    if (threadIdx.x == WG_THREADS && n > 0) {
      mbar_expect_tx(bars, 2 * W);
      for (int p = 0; p < QP; ++p) {
        tma_load_3d(k_s + p * BOX, &mk, bars, 32 * p, ks, bh);
        tma_load_3d(v_s + p * BOX, &mv, bars, 32 * p, ks, bh);
      }
      int s = 0;
      uint32_t phase = 0;
      for (int t = 0; t < n; ++t) {
        const int qs = f.table[(int64_t)f.krows[n0 + t] * 8 + 2];
        mbar_wait(empty(s), phase ^ 1);
        const uint32_t q = ring + s * 3 * W;
        mbar_expect_tx(full(s), 3 * W);
        for (int p = 0; p < QP; ++p) {
          tma_load_3d(q + p * BOX, &mq, full(s), 32 * p, qs, bh);
          tma_load_3d(q + W + p * BOX, &mdo, full(s), 32 * p, qs, bh);
          tma_load_3d(q + 2 * W + p * BOX, &mo, full(s), 32 * p, qs, bh);
        }
        if (++s == STAGES) { s = 0; phase ^= 1; }
      }
    }
    return;
  }

  // Consumers.  wgmma's accumulator layout: register 4 j + 2 i + c holds
  // row r0 + 8 i, column 8 j + c0 + c.  In S^T, dP^T, dK and dV the rows are
  // the window's keys; in S^T and dP^T the columns are its q rows.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
  const int64_t head = (int64_t)bh * f.sq;
  const float* LSE = f.lse + head;
  float* dQ = f.dq + head * f.d;
  float dk[DN / 2], dv[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) dk[i] = dv[i] = 0.f;
  int kpos[2];
  bool kok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    kpos[i] = ks + r0 + 8 * i;
    kok[i] = kpos[i] >= k0 && kpos[i] < k_end;
  }
  if (n > 0) mbar_wait(bars, 0);
  int st = 0;
  uint32_t phase = 0;
  for (int t = 0; t < n; ++t) {
    const int* row = f.table + (int64_t)f.krows[n0 + t] * 8;
    const int q0 = row[0], q_end = row[1], qs = row[2];
    const uint32_t q = ring + st * 3 * W, dO = q + W, o = dO + W;
    mbar_wait(full(st), phase);
    __syncwarp();  // wgmma is .aligned: the warp reconverges first

    // S^T = K Q^T and dP^T = V dO^T: d in QP panels of two k-steps each.
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < QP; ++p)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        wgmma_n64<0, 0>(s, desc_k64(k_s + p * BOX + 32 * h),
                        desc_k64(q + p * BOX + 32 * h));
    wgmma_commit();
#pragma unroll
    for (int p = 0; p < QP; ++p)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        wgmma_n64<0, 0>(dp, desc_k64(v_s + p * BOX + 32 * h),
                        desc_k64(dO + p * BOX + 32 * h));
    wgmma_commit();

    // While they run: the LSE and D = rowsum(dO . O) of the window's q
    // rows, two threads a row, each over half of the row's panels (columns
    // past d and rows past sq arrived as zeros).
    {
      const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
      const unsigned char* ob = smem + (o - base);
      const unsigned char* gb = smem + (dO - base);
      float acc = 0.f;
#pragma unroll
      for (int p = half * QP / 2; p < (half + 1) * QP / 2; ++p)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int off = p * BOX + r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
          acc += dot8(*reinterpret_cast<const uint4*>(ob + off),
                      *reinterpret_cast<const uint4*>(gb + off));
        }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (half == 0) {
        d_s[r] = acc;
        lse_s[r] = qs + r < f.sq ? LSE[qs + r] : 0.f;
      }
    }
    bar_sync(1, WG_THREADS);  // lse_s and d_s are written

    // P^T = exp(S^T scale - lse) where valid, else 0, in place of S^T.
    wgmma_wait<1>();
    fence_regs(s);
    uint32_t vmask = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qc = 8 * j + c0 + c, qpos = qs + qc;
        const bool qok = qpos >= q0 && qpos < q_end;
        const float l = lse_s[qc];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int idx = 4 * j + 2 * i + c;
          const bool ok = kok[i] && qok && (!f.causal || kpos[i] <= qpos);
          s[idx] = ok ? expf(s[idx] * f.scale - l) : 0.f;
          vmask |= (uint32_t)ok << idx;
        }
      }
    // The previous tile's wgmma reads of the P and dS panels ended at its
    // wait; order them before these generic writes.
    fence_proxy_async();
    store_tile(smem + (p_s - base), s, r0, c0);
    fence_proxy_async();      // P's generic writes, visible to wgmma
    bar_sync(1, WG_THREADS);  // every row of P is written

    // dV += P^T dO, the hi panels then the lo: four k-steps of 16 q rows.
    fence_regs(dv);
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_nd<DN, 0, 1>(
            dv, desc_k64(p_s + h * T_BYTES + (kk / 2) * BOX + (kk % 2) * 32),
            desc_mn64(dO + kk * 1024));
    wgmma_commit();

    // dS^T = P^T (dP^T - D) scale where valid, else 0, in place of dP^T.
    wgmma_wait<1>();  // dP^T is done; dV may still run
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float dd = d_s[8 * j + c0 + c];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int idx = 4 * j + 2 * i + c;
          const float x = s[idx] * (dp[idx] - dd) * f.scale;
          dp[idx] = (vmask >> idx) & 1u ? x : 0.f;
        }
      }
    store_tile(smem + (ds_s - base), dp, r0, c0);
    fence_proxy_async();
    bar_sync(1, WG_THREADS);  // every row of dS is written

    // dK += dS^T Q, hi then lo.
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_nd<DN, 0, 1>(
            dk, desc_k64(ds_s + h * T_BYTES + (kk / 2) * BOX + (kk % 2) * 32),
            desc_mn64(q + kk * 1024));
    wgmma_commit();

    // dQ = dS K, 64 columns of d at a time (q rows in M: dS^T read
    // MN-major), hi then lo, added into the owned q rows two columns an
    // atomic.
#pragma unroll
    for (int hn = 0; hn < DN / 64; ++hn) {
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_n64<1, 1>(acc, desc_mn64(ds_s + h * T_BYTES + kk * 1024),
                          desc_mn64(k_s + hn * 2 * BOX + kk * 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qpos = qs + r0 + 8 * i;
        if (qpos < q0 || qpos >= q_end) continue;
        float* qrow = dQ + (int64_t)qpos * f.d;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * hn + 8 * j + c0;
          if (col < f.d)
            red_add2(qrow + col, acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
        }
      }
    }
    fence_regs(dk);
    fence_regs(dv);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));  // this warp is done with the stage
    if (++st == STAGES) { st = 0; phase ^= 1; }
  }

  // The drain: the owned key rows [k0, k_end), pairs of columns below d
  // (zeros where no query reached the block).
  float* dK = f.dk + (int64_t)bh * f.sk * f.d;
  float* dV = f.dv + (int64_t)bh * f.sk * f.d;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!kok[i]) continue;
    const int64_t at = (int64_t)kpos[i] * f.d;
#pragma unroll
    for (int j = 0; j < DN / 8; ++j) {
      const int col = 8 * j + c0;
      if (col < f.d) {
        *reinterpret_cast<float2*>(dK + at + col) =
            make_float2(dk[4 * j + 2 * i], dk[4 * j + 2 * i + 1]);
        *reinterpret_cast<float2*>(dV + at + col) =
            make_float2(dv[4 * j + 2 * i], dv[4 * j + 2 * i + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

// Raises a kernel's dynamic shared-memory limit to `bytes`, once per
// kernel, so that a launch inside a CUDA-graph capture makes no attribute
// call.
template <auto kernel>
cudaError_t allow_smem(int bytes) {
  static const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return e;
}

template <typename T>
cudaError_t launch(const BwdArgs& f, dim3 grid, cudaStream_t s) {
  cudaError_t e = allow_smem<flash_bwd_kernel<T>>(
      (int)smem_bytes(BQ_MAX, BK_MAX, D_MAX));
  if (e != cudaSuccess) return e;
  flash_bwd_kernel<T><<<grid, NT, smem_bytes(f.bq, f.bk, f.d), s>>>(f);
  return cudaGetLastError();
}

// Route A's tensor maps: every operand in boxes of 32 columns x 64 rows
// (K-major, 64-byte swizzle), 3-D over (BH, s, d) with the head's own
// extent.
template <int DN>
cudaError_t launch_wgmma(const BwdArgs& f, dim3 grid, cudaStream_t s) {
  CUtensorMap mq{}, mk{}, mv{}, mo{}, mdo{};
  const auto sw = CU_TENSOR_MAP_SWIZZLE_64B;
  if (!(wgt::make_map(&mq, f.q, f.d, f.sq, grid.y, 32, 64, sw) &&
        wgt::make_map(&mk, f.k, f.d, f.sk, grid.y, 32, 64, sw) &&
        wgt::make_map(&mv, f.v, f.d, f.sk, grid.y, 32, 64, sw) &&
        wgt::make_map(&mo, f.o, f.d, f.sq, grid.y, 32, 64, sw) &&
        wgt::make_map(&mdo, f.dout, f.d, f.sq, grid.y, 32, 64, sw)))
    return cudaErrorInvalidValue;
  constexpr int smem = tc_smem<DN>();
  cudaError_t e = allow_smem<flash_bwd_wgmma<DN>>(smem);
  if (e != cudaSuccess) return e;
  flash_bwd_wgmma<DN><<<grid, TC_THREADS, smem, s>>>(mq, mk, mv, mo, mdo, f);
  return cudaGetLastError();
}

}  // namespace

// route: ROUTE_A (TMA ring + wgmma) or ROUTE_C (CUDA cores) for bf16,
// ignored for fp32 (CUDA cores).
extern "C" int flash_bwd_fused(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const float* lse, float* dq, float* dk,
                               float* dv, const int* table, const int* koff,
                               const int* krows, int num_k_blocks, int bh,
                               int sq, int sk, int d, int bq, int bk,
                               int causal, float scale, int dtype, int route,
                               void* stream) {
  BwdArgs f{q,  k,    v,     o,  dout, lse, dq, dk,     dv,   table,
            koff, krows, sq, sk, d,    bq,  bk, causal, scale};
  if (bq < 1 || bq > BQ_MAX || bk < 1 || bk > BK_MAX || d < 1 || d > D_MAX ||
      bq > sq || bk > sk)
    return cudaErrorInvalidValue;
  dim3 grid(num_k_blocks, bh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && route == ROUTE_A)
    return d <= 64 ? launch_wgmma<64>(f, grid, s) : launch_wgmma<128>(f, grid, s);
  if (dtype == 1 && route == ROUTE_C) return launch<__nv_bfloat16>(f, grid, s);
  if (dtype == 0) return launch<float>(f, grid, s);
  return cudaErrorInvalidValue;
}
