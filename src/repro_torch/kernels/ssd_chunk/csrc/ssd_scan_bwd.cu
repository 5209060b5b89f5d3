// Backward of the Mamba-2 SSD chunked scan for Hopper (sm_90a): one launch
// walks every group's chunks last to first with the (p, n) state cotangent
// carried, and writes all seven cotangents (ssd_scan_bwd).
//
// Replaces the reference package's TPU kernel
// src/repro/kernels/ssd_chunk/kernel.py::build_ssd_scan_bwd_kernel
// (_ssd_scan_bwd_body).  There a (groups, chunks) grid with the chunk
// coordinate flipped walks chunks in reverse, dS in VMEM scratch, each
// step recomputing a whole chunk's (Q, Q) scores in VMEM.  Per chunk, with
// S_in the state the forward saved on entry and dS the cotangent of the
// state leaving the chunk:
//
//   scores = C·Bᵀ, dW = dY·xdtᵀ, dL = dW ⊙ scores,
//   dC   = (dW ⊙ L)·B + (dY ⊙ di)·S_in,
//   dB   = (dW ⊙ L)ᵀ·C + (xdt ⊙ do)·dS,
//   dxdt = (scores ⊙ L)ᵀ·dY + (B·dSᵀ) ⊙ do,
//   d_decay_out = Σ_p (B·dSᵀ) ⊙ xdt,
//   d_decay_in  = Σ_p dY ⊙ (C·S_inᵀ), plus Σ S_in ⊙ dS on the last row,
//   dS ← dS · di[Q-1] + (dY ⊙ di)ᵀ·C; ds0 is dS after the first chunk.
//
// Numerics follow the reference kernel: every operand widened to fp32, no
// rounding point (dY and dS_final arrive as fp32), every cotangent fp32.
// No atomics: every output element has one writer and every sum a fixed
// order, so two runs give the same bits.  Two routes, chosen per call in
// kernel.py (choose_bwd_route), which counts them:
//
// (A) bf16 C and B, fp32 L and xdt, Q a multiple of 64, n = 128, p = 64,
//     16-byte aligned operands: mamba2's training path.  What bounds it on
//     the H100 at the training shape (192 groups x 4 chunks of 256): about
//     142 GFLOP of bf16 wgmma (0.14 ms at 989 TFLOP/s, an fp32 x bf16
//     product counted as two bf16 products and fp32 x fp32 as three)
//     against about 0.9 GB (0.27 ms at 3.35 TB/s; dL alone is 201 MB), so
//     bytes.  Route B is bound by its fp32 CUDA-core products instead, with
//     one block a group (1.45 waves of 192 blocks).  The design:
//     * Only the state leg reads the carried dS, so a group's chunks are
//       split over a thread-block cluster of min(NC, 8) blocks, each rank a
//       contiguous run of chunks (one each at NC <= 8: 768 blocks at the
//       training shape, two an SM).  Each rank first folds its chunks'
//       increments inc = (dY ⊙ di)ᵀ·C from zero, acc ← acc · di[Q-1] + inc
//       from its last chunk down, and publishes that (p, n) fp32 tile and
//       the product of the decays in its shared memory.  After a cluster
//       barrier each rank folds dS_final through the higher ranks' tiles
//       over distributed shared memory, last rank first, as the reference
//       walks (one multiply and one add each, no FMA); rank 0 folds its own
//       tile too and writes ds0.  A rank with several chunks walks them in
//       order, recomputing each increment, with dS carried in fp32 (32 KB
//       more shared memory).
//     * Every product runs on wgmma, one warpgroup a block, fp32 sums.  C
//       and B go in exactly; fp32 operands are split into hi = bf16(x) and
//       lo = bf16(x - hi) (2^-16 relative left out), an fp32 x bf16
//       product runs twice and fp32 x fp32 three times (hi hi, hi lo, lo
//       hi); never TF32.  S_in, dS and dY ⊙ di take a third piece (2^-24
//       left out) in C_i·S_inᵀ, B_j·dSᵀ and the increment, which feed the
//       row sums d_decay_in and d_decay_out: with two pieces those came
//       closest to the 1e-3 bound at the training shape.  Per chunk, in
//       64-row windows (ssd_sm90.cuh):
//         columns j: the state leg B_j·dSᵀ and xdt_j·dS (then scaled by
//                    do), d_decay_out; then over the rows i, scoresᵀ =
//                    B_j·C_iᵀ and dWᵀ = xdt_j·dY_iᵀ, dL written, and
//                    dB_j += (dW ⊙ L)ᵀ·C_i, dxdt_j += (scores ⊙ L)ᵀ·dY_i
//                    with both (Q, Q) factors split in registers into
//                    wgmma's A fragments; dB_j and dxdt_j stay in registers;
//         rows i:    the state leg C_i·S_inᵀ (d_decay_in) and dY_i·S_in
//                    (then scaled by di); then over the columns j, dW =
//                    dY_i·xdt_jᵀ again (the cheapest product, K = p, from
//                    windows L2 still holds) and dC_i += (dW ⊙ L)·B_j, dC_i
//                    in registers.
//       That is 6 products of a chunk's (Q, Q) size where the math needs
//       5: writing dW ⊙ L to a scratch as large as L for the rows instead
//       measured slower (its writes, then its reads from HBM).
//     * The block stages its windows with its own 16-byte loads, all of a
//       staging's loads issued before its first store: the fp32 operands
//       are split on their way into the swizzled panels, which a TMA copy
//       would need a second pass in shared memory for.  While a tile
//       computes, the next tile's windows and rows of L are requested into
//       L2.  L and the decays are read straight from global memory in the
//       accumulator layout, every warp load covering whole 32-byte
//       sectors (L's second read, by the rows, mostly hits L2).  Two
//       blocks an SM (113 KB of shared memory and 255 registers a thread
//       each) overlap one's loads with the other's products.
//     What still bounds it (about 1.0 ms at the training shape against the
//     0.27 ms bound): within a block the staging, the products and the
//     element-wise work on L run one after another, and a second block an
//     SM covers only part of each wait.  Double-buffered windows fed by a
//     producer (cp.async or TMA) need shared memory the three-piece state
//     windows hold; freeing it means computing the state leg in a pass of
//     its own.
// (B) everything else (fp32 C and B, bf16 L or xdt, other Q, n or p): one
//     256-thread block a group walks its chunks last to first with dS in
//     shared memory, in three fp32 CUDA-core passes a chunk (block_mm):
//       rows:    per block of RB rows and slice of RB columns, scores and
//                dW recomputed; dL, dC and d_decay_in;
//       columns: per block of RB columns, dB and dxdt gather every row's
//                contribution on top of the state leg, d_decay_out; a block
//                owns its columns' accumulators in shared memory;
//       state:   dS ← dS · di[Q-1] + (dY ⊙ di)ᵀ·C.
//     Each pass recomputes what it needs instead of staging the (Q, Q)
//     tiles or a whole chunk's fp32 accumulators, which do not fit beside
//     the two (p, n) states.

#include <climits>

#include "ssd_common.cuh"
#include "ssd_sm90.cuh"

namespace {

using namespace ssd;

enum { ROUTE_A = 0, ROUTE_B = 1 };

// ---------------------------------------------------------------------------
// Route B: one block a group, fp32 CUDA-core products.
// ---------------------------------------------------------------------------

constexpr int RB = 32;  // rows per block step and columns per slice

struct BwdArgs {
  Operand c, b, l, x;     // the forward's operands
  const float* di;        // (cells, Q)
  const float* dout;      // (cells, Q)
  const float* states;    // (cells, p, n) state entering each chunk
  const float* dy;        // (cells, Q, p) fp32
  const float* dsf;       // (G, p, n) fp32
  float *dc, *db, *dl, *dx, *ddi, *ddo, *ds0;  // fp32, shaped as their primal
  int chunks, q, n, p;
};

size_t smem_floats(int q, int n, int p) {
  const size_t ldn = n | 1, ldp = p | 1, ldt = RB | 1;
  return 2 * p * ldn + 2 * RB * ldn + 2 * RB * ldp + 2 * RB * ldt +
         (size_t)RB * n + (size_t)RB * p + 2 * (size_t)q + NT;
}

__global__ void __launch_bounds__(NT) ssd_bwd_route_b(BwdArgs f) {
  extern __shared__ float smem[];
  const int q = f.q, n = f.n, p = f.p;
  const int ldn = n | 1, ldp = p | 1, ldt = RB | 1;
  float* sDS = smem;             // p x ldn: cotangent of S leaving the chunk
  float* sSin = sDS + p * ldn;   // p x ldn: S entering the chunk
  float* sC = sSin + p * ldn;    // RB x ldn
  float* sB = sC + RB * ldn;     // RB x ldn
  float* sX = sB + RB * ldn;     // RB x ldp
  float* sDY = sX + RB * ldp;    // RB x ldp
  float* sT1 = sDY + RB * ldp;   // RB x ldt
  float* sT2 = sT1 + RB * ldt;   // RB x ldt
  float* sA1 = sT2 + RB * ldt;   // RB x n: dC rows, or dB columns
  float* sA2 = sA1 + RB * n;     // RB x p: dxdt columns
  float* sDi = sA2 + RB * p;     // Q
  float* sDo = sDi + q;          // Q
  float* sRed = sDo + q;         // NT
  const int64_t g = blockIdx.x;
  for (int i = threadIdx.x; i < p * n; i += NT)
    sDS[(i / n) * ldn + i % n] = f.dsf[g * p * n + i];
  for (int step = 0; step < f.chunks; ++step) {
    const int64_t cell = g * f.chunks + (f.chunks - 1 - step);
    const int64_t cq = cell * q;  // the cell's first row
    __syncthreads();  // dS_final loaded, or the previous chunk's dS done
    for (int i = threadIdx.x; i < p * n; i += NT)
      sSin[(i / n) * ldn + i % n] = f.states[cell * p * n + i];
    for (int i = threadIdx.x; i < q; i += NT) {
      sDi[i] = f.di[cq + i];
      sDo[i] = f.dout[cq + i];
    }
    __syncthreads();
    // Σ S_in ⊙ dS, summed in a fixed order.
    float part = 0.f;
    for (int i = threadIdx.x; i < p * n; i += NT) {
      const int e = (i / n) * ldn + i % n;
      part = fmaf(sSin[e], sDS[e], part);
    }
    sRed[threadIdx.x] = part;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int t = 0; t < NT; ++t) s += sRed[t];
      sRed[0] = s;
    }
    __syncthreads();
    const float ddi_last = sRed[0];

    // ---- rows: dL, dC, d_decay_in ----------------------------------------
    for (int rb = 0; rb < q; rb += RB) {
      const int rows = min(RB, q - rb);
      __syncthreads();  // the previous row block's readers are done
      load_tile(sC, ldn, f.c, (cq + rb) * n, rows, n, n);
      load_tile(sDY, ldp, f.dy, (cq + rb) * p, rows, p, p);
      for (int i = threadIdx.x; i < rows * n; i += NT) sA1[i] = 0.f;
      for (int jb = 0; jb < q; jb += RB) {
        const int cols = min(RB, q - jb);
        __syncthreads();
        load_tile(sB, ldn, f.b, (cq + jb) * n, cols, n, n);
        load_tile(sX, ldp, f.x, (cq + jb) * p, cols, p, p);
        __syncthreads();
        block_mm(
            rows, cols, n, [&](int m, int k) { return sC[m * ldn + k]; },
            [&](int j, int k) { return sB[j * ldn + k]; },
            [&](int m, int j, float s) { sT1[m * ldt + j] = s; });
        // The same (M, N): each (m, j) has the owner that wrote sT1.
        block_mm(
            rows, cols, p, [&](int m, int k) { return sDY[m * ldp + k]; },
            [&](int j, int k) { return sX[j * ldp + k]; },
            [&](int m, int j, float dw) {
              const int64_t e = (cq + rb + m) * q + jb + j;
              f.dl[e] = dw * sT1[m * ldt + j];
              sT2[m * ldt + j] = dw * f.l[e];
            });
        __syncthreads();
        block_mm(
            rows, n, cols, [&](int m, int k) { return sT2[m * ldt + k]; },
            [&](int c, int k) { return sB[k * ldn + c]; },
            [&](int m, int c, float v) { sA1[m * n + c] += v; });
      }
      // dC = dscores · B + (dY ⊙ di) · S_in, by the owners of sA1.
      block_mm(
          rows, n, p,
          [&](int m, int k) { return sDY[m * ldp + k] * sDi[rb + m]; },
          [&](int c, int k) { return sSin[k * ldn + c]; },
          [&](int m, int c, float v) {
            f.dc[(cq + rb + m) * n + c] = sA1[m * n + c] + v;
          });
      __syncthreads();  // sX is free
      block_mm(
          rows, p, n, [&](int m, int k) { return sC[m * ldn + k]; },
          [&](int c, int k) { return sSin[c * ldn + k]; },
          [&](int m, int c, float v) {
            sX[m * ldp + c] = sDY[m * ldp + c] * v;
          });
      __syncthreads();
      for (int m = threadIdx.x; m < rows; m += NT) {
        float s = 0.f;
        for (int c = 0; c < p; ++c) s += sX[m * ldp + c];
        if (rb + m == q - 1) s += ddi_last;
        f.ddi[cq + rb + m] = s;
      }
    }

    // ---- columns: dB, dxdt, d_decay_out -------------------------------
    for (int jb = 0; jb < q; jb += RB) {
      const int cols = min(RB, q - jb);
      __syncthreads();
      load_tile(sB, ldn, f.b, (cq + jb) * n, cols, n, n);
      load_tile(sX, ldp, f.x, (cq + jb) * p, cols, p, p);
      __syncthreads();
      // dxw = B · dSᵀ: dxdt starts as dxw ⊙ do, and sDY takes dxw ⊙ xdt.
      block_mm(
          cols, p, n, [&](int j, int k) { return sB[j * ldn + k]; },
          [&](int c, int k) { return sDS[c * ldn + k]; },
          [&](int j, int c, float v) {
            sA2[j * p + c] = v * sDo[jb + j];
            sDY[j * ldp + c] = v * sX[j * ldp + c];
          });
      // dB starts as (xdt ⊙ do) · dS.
      block_mm(
          cols, n, p,
          [&](int j, int k) { return sX[j * ldp + k] * sDo[jb + j]; },
          [&](int c, int k) { return sDS[k * ldn + c]; },
          [&](int j, int c, float v) { sA1[j * n + c] = v; });
      __syncthreads();
      for (int j = threadIdx.x; j < cols; j += NT) {
        float s = 0.f;
        for (int c = 0; c < p; ++c) s += sDY[j * ldp + c];
        f.ddo[cq + jb + j] = s;
      }
      for (int ib = 0; ib < q; ib += RB) {
        const int rows = min(RB, q - ib);
        __syncthreads();
        load_tile(sC, ldn, f.c, (cq + ib) * n, rows, n, n);
        load_tile(sDY, ldp, f.dy, (cq + ib) * p, rows, p, p);
        __syncthreads();
        // sT1 = scores ⊙ L (= w), sT2 = L then dW ⊙ L (= dscores).
        block_mm(
            rows, cols, n, [&](int i, int k) { return sC[i * ldn + k]; },
            [&](int j, int k) { return sB[j * ldn + k]; },
            [&](int i, int j, float s) {
              const float lv = f.l[(cq + ib + i) * q + jb + j];
              sT1[i * ldt + j] = s * lv;
              sT2[i * ldt + j] = lv;
            });
        block_mm(
            rows, cols, p, [&](int i, int k) { return sDY[i * ldp + k]; },
            [&](int j, int k) { return sX[j * ldp + k]; },
            [&](int i, int j, float dw) { sT2[i * ldt + j] *= dw; });
        __syncthreads();
        block_mm(
            cols, n, rows, [&](int j, int k) { return sT2[k * ldt + j]; },
            [&](int c, int k) { return sC[k * ldn + c]; },
            [&](int j, int c, float v) { sA1[j * n + c] += v; });
        block_mm(
            cols, p, rows, [&](int j, int k) { return sT1[k * ldt + j]; },
            [&](int c, int k) { return sDY[k * ldp + c]; },
            [&](int j, int c, float v) { sA2[j * p + c] += v; });
      }
      __syncthreads();
      for (int i = threadIdx.x; i < cols * n; i += NT)
        f.db[(cq + jb) * n + i] = sA1[i];
      for (int i = threadIdx.x; i < cols * p; i += NT)
        f.dx[(cq + jb) * p + i] = sA2[i];
    }

    // ---- state: dS ← dS · di[Q-1] + (dY ⊙ di)ᵀ · C ----------------------
    __syncthreads();
    const float dlast = sDi[q - 1];
    for (int i = threadIdx.x; i < p * n; i += NT)
      sDS[(i / n) * ldn + i % n] *= dlast;
    for (int rb = 0; rb < q; rb += RB) {
      const int rows = min(RB, q - rb);
      __syncthreads();
      load_tile(sC, ldn, f.c, (cq + rb) * n, rows, n, n);
      for (int i = threadIdx.x; i < rows * p; i += NT) {
        const int r = i / p, c = i - r * p;
        sDY[r * ldp + c] = f.dy[(cq + rb + r) * p + c] * sDi[rb + r];
      }
      __syncthreads();
      block_mm(
          p, n, rows, [&](int c, int k) { return sDY[k * ldp + c]; },
          [&](int e, int k) { return sC[k * ldn + e]; },
          [&](int c, int e, float v) { sDS[c * ldn + e] += v; });
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < p * n; i += NT)
    f.ds0[g * p * n + i] = sDS[(i / n) * ldn + i % n];
}



// ---------------------------------------------------------------------------
// Route A: a cluster of blocks a group, wgmma products.
// ---------------------------------------------------------------------------

constexpr int A_BLOCK = 64;      // rows of a window; Q is a multiple of it
constexpr int A_STATE = 128;     // n
constexpr int A_HEAD_DIM = 64;   // p
constexpr int MAX_CLUSTER = 8;   // the portable thread-block cluster size
// Shared memory of a route-A block: 512 bytes of alignment slack (the
// 64-byte swizzle repeats every 512); the state region (the published fp32
// (p, n) tile, then dS or S_in in three split windows: the products
// C_i·S_inᵀ and B_j·dSᵀ feed row sums of 64 terms, d_decay_in and
// d_decay_out, where the two-piece split's 2^-16 costs most of the 1e-3
// bound); the B_j and C_i windows; the xdt_j and dY_i split windows, side
// by side so that the increment's three pieces of dY ⊙ di fill both; 64
// bytes of warp sums and the published decay; and, where a rank walks
// more than one chunk, the fp32 dS it carries (A_CARRY_BYTES).
constexpr int A_STATE_WINDOW = A_HEAD_DIM * A_STATE * 2;
constexpr int A_STATE_BYTES = 3 * A_STATE_WINDOW;            // hi, lo, lo2
constexpr int A_NB_BYTES = A_BLOCK * A_STATE * 2;
constexpr int A_NP_BYTES = 2 * A_BLOCK * A_HEAD_DIM * 2;     // hi + lo
constexpr int A_SMEM =
    512 + A_STATE_BYTES + 2 * A_NB_BYTES + 2 * A_NP_BYTES + 64;
constexpr int A_CARRY_BYTES = A_HEAD_DIM * A_STATE * 4;
static_assert(2 * (A_SMEM + 1024) <= 233472, "two route-A blocks an SM");
static_assert(A_SMEM + A_CARRY_BYTES <= 232448, "a carrying block fits");

struct BwdArgsA {
  const __nv_bfloat16 *c, *b;  // (cells, Q, n)
  const float* l;              // (cells, Q, Q)
  const float* x;              // (cells, Q, p)
  const float *di, *dout;      // (cells, Q)
  const float* states;         // (cells, p, n)
  const float* dy;             // (cells, Q, p)
  const float* dsf;            // (G, p, n)
  float *dc, *db, *dl, *dx, *ddi, *ddo, *ds0;
  int chunks, q, cluster;
};

struct SmemA {
  unsigned char *state, *b, *c, *x, *y;
  float* red;    // [0, 4): warp sums; [4]: the published decay product
  float* carry;  // (p, n) fp32 dS of a rank that walks several chunks
  uint32_t a_state, a_b, a_c, a_x, a_y;
  __device__ explicit SmemA(unsigned char* base)
      : state(base),
        b(state + A_STATE_BYTES),
        c(b + A_NB_BYTES),
        x(c + A_NB_BYTES),
        y(x + A_NP_BYTES),
        red(reinterpret_cast<float*>(y + A_NP_BYTES)),
        carry(red + 16),
        a_state(sm90::smem_u32(state)),
        a_b(sm90::smem_u32(b)),
        a_c(sm90::smem_u32(c)),
        a_x(sm90::smem_u32(x)),
        a_y(sm90::smem_u32(y)) {}
};

__device__ __forceinline__ unsigned char* align512(unsigned char* raw) {
  const uint32_t a = sm90::smem_u32(raw);
  return raw + (((a + 511) & ~511u) - a);
}

// A thread's accumulator rows (r0, r0 + 8) and first column c0.
__device__ __forceinline__ int acc_r0() {
  return 16 * (threadIdx.x / 32) + (threadIdx.x % 32) / 4;
}
__device__ __forceinline__ int acc_c0() { return 2 * (threadIdx.x % 4); }

// Asks L2 for the tile an iteration stages next, while this one computes:
// rows [r, r + 64) of the (Q, n) bf16 matrix m and of the (Q, p) fp32
// matrix v, and, where given, 64 rows of 64 fp32 of L from `lrow`.
__device__ __forceinline__ void prefetch_tile(const __nv_bfloat16* m,
                                              const float* v, int64_t r,
                                              const float* lrow, int q) {
  const int rr = threadIdx.x / 2, half = threadIdx.x % 2;
  ssd_sm90::prefetch_l2(m + (r + rr) * A_STATE + half * (A_STATE / 2));
  ssd_sm90::prefetch_l2(v + (r + rr) * A_HEAD_DIM + half * (A_HEAD_DIM / 2));
  if (lrow != nullptr)
    ssd_sm90::prefetch_l2(lrow + (int64_t)rr * q + half * 32);
}

// The block's sum of one value a thread, in a fixed order.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  const float s = (red[0] + red[1]) + (red[2] + red[3]);
  __syncthreads();  // red is free again
  return s;
}

// The sum over a 64 x 64 accumulator row (h: r0 or r0 + 8) of x ⊙ v, v
// an fp32 row of 64 in global memory, across the four threads of the row.
__device__ __forceinline__ float row_dot(const float* x, int h,
                                         const float* v) {
  const int c0 = acc_c0();
  float sum = 0.f;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const float2 w = __ldg(reinterpret_cast<const float2*>(v + 8 * t + c0));
    sum = fmaf(x[4 * t + 2 * h], w.x, sum);
    sum = fmaf(x[4 * t + 2 * h + 1], w.y, sum);
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  return sum + __shfl_xor_sync(0xffffffffu, sum, 2);
}

template <int N>
__device__ __forceinline__ void scale_row(float (&x)[N], int h, float s) {
#pragma unroll
  for (int t = 0; t < N / 4; ++t) {
    x[4 * t + 2 * h] *= s;
    x[4 * t + 2 * h + 1] *= s;
  }
}

// A thread's part of a 64 x 2N accumulator (N registers) into the rows
// from `row0` of a row-major fp32 matrix of 2N columns.
template <int N>
__device__ __forceinline__ void store_rows(float* out, const float (&x)[N],
                                           int64_t row0) {
  const int r0 = acc_r0(), c0 = acc_c0();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* row = out + (row0 + r0 + 8 * h) * (2 * N);
#pragma unroll
    for (int t = 0; t < N / 4; ++t)
      *reinterpret_cast<float2*>(row + 8 * t + c0) =
          make_float2(x[4 * t + 2 * h], x[4 * t + 2 * h + 1]);
  }
}

// Stages rows [r, r + 64) of a chunk: the bf16 (Q, n) window of m (C or B)
// at w, the (Q, p) rows of v (dY or xdt, times `scale` where given) in
// PIECES split windows at wp.
template <int PIECES = 2>
__device__ __forceinline__ void stage_rows(unsigned char* w,
                                           const __nv_bfloat16* m,
                                           unsigned char* wp, const float* v,
                                           int64_t r, const float* scale) {
  ssd_sm90::Bf16Rows<A_STATE> mr;
  ssd_sm90::F32Rows<A_HEAD_DIM> vr;
  mr.load(m + r * A_STATE, A_STATE);
  vr.load(v + r * A_HEAD_DIM, A_HEAD_DIM, scale);
  __syncthreads();  // the windows' previous readers are done
  mr.store(w);
  vr.template store<PIECES>(wp);
  sm90::fence_proxy_async();  // generic writes, visible to wgmma
  __syncthreads();
}

// inc = (dY ⊙ di)ᵀ·C of one chunk, (p, n) in the accumulator layout: its
// rows 64 at a time, dY ⊙ di in three split windows (the xdt and dY
// windows) read MN-major as A.  The increments set dS, and through it
// d_decay_out's row sums, so they take the third piece.
__device__ void chunk_inc(const BwdArgsA& f, const SmemA& s, int64_t cell,
                          float (&inc)[64]) {
  using namespace ssd_sm90;
  const int64_t row0 = cell * f.q;
  zero(inc);
  for (int ib = 0; ib < f.q; ib += A_BLOCK) {
    stage_rows<3>(s.c, f.c, s.x, f.dy, row0 + ib, f.di + row0 + ib);
    if (ib + A_BLOCK < f.q)
      prefetch_tile(f.c, f.dy, row0 + ib + A_BLOCK, nullptr, f.q);
    sm90::fence_regs(inc);
    sm90::wgmma_fence();
#pragma unroll
    for (int pc = 0; pc < 3; ++pc)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<128, 1, 1>(inc, mnmaj(s.a_x + pc * (A_NP_BYTES / 2), kk),
                            mnmaj(s.a_c, kk));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(inc);
  }
}

// Makes ds (a thread's part of the (p, n) accumulator layout) the
// cotangent of the state leaving chunk `cell`: its three split windows into
// the state region, its fp32 values kept where the rank walks more chunks.
// Returns Σ S_in ⊙ dS over the chunk's entering state.
__device__ float set_ds(const BwdArgsA& f, const SmemA& s, int64_t cell,
                        const float (&ds)[64], bool carry) {
  const int r0 = acc_r0(), c0 = acc_c0();
  const float* sin = f.states + cell * (A_HEAD_DIM * A_STATE);
  __syncthreads();  // the state region's readers are done
  float part = 0.f;
#pragma unroll
  for (int t = 0; t < 16; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = 4 * t + 2 * h, pos = (r0 + 8 * h) * A_STATE + 8 * t + c0;
      const float2 v = __ldg(reinterpret_cast<const float2*>(sin + pos));
      part = fmaf(ds[e], v.x, part);
      part = fmaf(ds[e + 1], v.y, part);
      if (carry)
        *reinterpret_cast<float2*>(s.carry + pos) =
            make_float2(ds[e], ds[e + 1]);
    }
  ssd_sm90::store_split<64, 3>(s.state, ds);
  sm90::fence_proxy_async();
  return block_sum(part, s.red);  // its barrier publishes the window
}

// Columns j of one chunk: dB, dxdt, d_decay_out and dL.
__device__ void column_pass(const BwdArgsA& f, const SmemA& s, int64_t cell) {
  using namespace ssd_sm90;
  const int q = f.q, r0 = acc_r0(), c0 = acc_c0();
  const int64_t row0 = cell * q;
  const float* L = f.l + row0 * q;
  float* dL = f.dl + row0 * q;
  constexpr int LO_P = A_NP_BYTES / 2, LO_S = A_STATE_WINDOW;
  for (int jb = 0; jb < q; jb += A_BLOCK) {
    stage_rows(s.b, f.b, s.x, f.x, row0 + jb, nullptr);
    // The state leg: dxw = B_j·dSᵀ (dS in three pieces) into dx,
    // xdt_j·dS into db.
    float db[64], dx[32];
    zero(db);
    zero(dx);
    sm90::fence_regs(db);
    sm90::fence_regs(dx);
    sm90::wgmma_fence();
    mma_kk<64, 8>(dx, s.a_b, s.a_state);
    mma_kk<64, 8>(dx, s.a_b, s.a_state + LO_S);
    mma_kk<64, 8>(dx, s.a_b, s.a_state + 2 * LO_S);
    mma_km<128>(db, s.a_x, s.a_state);
    mma_km<128>(db, s.a_x, s.a_state + LO_S);
    mma_km<128>(db, s.a_x + LO_P, s.a_state);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(db);
    sm90::fence_regs(dx);
    // d_decay_out = Σ_p dxw ⊙ xdt; dxdt starts as dxw ⊙ do, dB as
    // do ⊙ (xdt·dS).
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t j = row0 + jb + r0 + 8 * h;
      const float sum = row_dot(dx, h, f.x + j * A_HEAD_DIM);
      if (threadIdx.x % 4 == 0) f.ddo[j] = sum;
      const float dov = f.dout[j];
      scale_row(dx, h, dov);
      scale_row(db, h, dov);
    }
    for (int ib = 0; ib < q; ib += A_BLOCK) {
      stage_rows(s.c, f.c, s.y, f.dy, row0 + ib, nullptr);
      // The next tile: the next rows i, or the first of the next columns.
      const int ni = ib + A_BLOCK < q ? ib + A_BLOCK : 0;
      const int nj = ib + A_BLOCK < q ? jb : jb + A_BLOCK;
      if (nj < q)
        prefetch_tile(f.c, f.dy, row0 + ni, L + (int64_t)ni * q + nj, q);
      // scoresᵀ = B_j·C_iᵀ and dWᵀ = xdt_j·dY_iᵀ (hi hi, hi lo, lo hi).
      float st[32], dwt[32];
      zero(st);
      zero(dwt);
      sm90::fence_regs(st);
      sm90::fence_regs(dwt);
      sm90::wgmma_fence();
      mma_kk<64, 8>(st, s.a_b, s.a_c);
      mma_kk<64, 4>(dwt, s.a_x, s.a_y);
      mma_kk<64, 4>(dwt, s.a_x, s.a_y + LO_P);
      mma_kk<64, 4>(dwt, s.a_x + LO_P, s.a_y);
      sm90::wgmma_commit();
      // The tile of L while they run: element (j, i) is L[i][j].
      float lt[32];
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            lt[4 * t + 2 * h + c] =
                __ldg(L + (int64_t)(ib + 8 * t + c0 + c) * q + jb + r0 + 8 * h);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(st);
      sm90::fence_regs(dwt);
      // dL = dW ⊙ scores, written where L was read; dscores = dW ⊙ L and
      // w = scores ⊙ L in place.
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * t + 2 * h + c;
            const int64_t at = (int64_t)(ib + 8 * t + c0 + c) * q + jb + r0 +
                               8 * h;
            dL[at] = dwt[e] * st[e];
            dwt[e] *= lt[e];
            st[e] *= lt[e];
          }
      // dB_j += dscoresᵀ·C_i, then dxdt_j += wᵀ·dY_i.
      Frag dh, dlo, wh, wlo;
      frag_split(dwt, dh, dlo);
      sm90::fence_regs(db);
      sm90::wgmma_fence();
      mma_rm<128>(db, dh, s.a_c);
      mma_rm<128>(db, dlo, s.a_c);
      sm90::wgmma_commit();
      frag_split(st, wh, wlo);
      sm90::fence_regs(dx);
      sm90::wgmma_fence();
      mma_rm<64>(dx, wh, s.a_y);
      mma_rm<64>(dx, wh, s.a_y + LO_P);
      mma_rm<64>(dx, wlo, s.a_y);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(db);
      sm90::fence_regs(dx);
      fence_frag(dh);
      fence_frag(dlo);
      fence_frag(wh);
      fence_frag(wlo);
    }
    store_rows(f.db, db, row0 + jb);
    store_rows(f.dx, dx, row0 + jb);
  }
}

// Rows i of one chunk: dC and d_decay_in.
__device__ void row_pass(const BwdArgsA& f, const SmemA& s, int64_t cell,
                         float ddi_last) {
  using namespace ssd_sm90;
  const int q = f.q, r0 = acc_r0(), c0 = acc_c0();
  const int64_t row0 = cell * q;
  const float* L = f.l + row0 * q;
  constexpr int LO_P = A_NP_BYTES / 2, LO_S = A_STATE_WINDOW;
  __syncthreads();  // the column pass's readers of the dS windows are done
  F32Rows<A_STATE> rows;  // S_in, in three pieces
  rows.load(f.states + cell * (A_HEAD_DIM * A_STATE), A_STATE, nullptr);
  rows.store<3>(s.state);
  for (int ib = 0; ib < q; ib += A_BLOCK) {
    stage_rows(s.c, f.c, s.y, f.dy, row0 + ib, nullptr);
    // The state leg: y_off = C_i·S_inᵀ (S_in in three pieces), and
    // dY_i·S_in into dc.
    float dc[64], yo[32];
    zero(dc);
    zero(yo);
    sm90::fence_regs(dc);
    sm90::fence_regs(yo);
    sm90::wgmma_fence();
    mma_kk<64, 8>(yo, s.a_c, s.a_state);
    mma_kk<64, 8>(yo, s.a_c, s.a_state + LO_S);
    mma_kk<64, 8>(yo, s.a_c, s.a_state + 2 * LO_S);
    mma_km<128>(dc, s.a_y, s.a_state);
    mma_km<128>(dc, s.a_y, s.a_state + LO_S);
    mma_km<128>(dc, s.a_y + LO_P, s.a_state);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dc);
    sm90::fence_regs(yo);
    // d_decay_in = Σ_p dY ⊙ y_off (+ Σ S_in ⊙ dS on the chunk's last
    // row); dC starts as di ⊙ (dY·S_in).
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = ib + r0 + 8 * h;
      const float sum = row_dot(yo, h, f.dy + (row0 + i) * A_HEAD_DIM);
      if (threadIdx.x % 4 == 0)
        f.ddi[row0 + i] = i == q - 1 ? sum + ddi_last : sum;
      scale_row(dc, h, f.di[row0 + i]);
    }
    for (int jb = 0; jb < q; jb += A_BLOCK) {
      stage_rows(s.b, f.b, s.x, f.x, row0 + jb, nullptr);
      if (jb + A_BLOCK < q)
        prefetch_tile(f.b, f.x, row0 + jb + A_BLOCK,
                      L + (int64_t)ib * q + jb + A_BLOCK, q);
      // dW = dY_i·xdt_jᵀ (hi hi, hi lo, lo hi).
      float dw[32];
      zero(dw);
      sm90::fence_regs(dw);
      sm90::wgmma_fence();
      mma_kk<64, 4>(dw, s.a_y, s.a_x);
      mma_kk<64, 4>(dw, s.a_y, s.a_x + LO_P);
      mma_kk<64, 4>(dw, s.a_y + LO_P, s.a_x);
      sm90::wgmma_commit();
      float lv[32];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float2 v = __ldg(reinterpret_cast<const float2*>(
              L + (int64_t)(ib + r0 + 8 * h) * q + jb + 8 * t + c0));
          lv[4 * t + 2 * h] = v.x;
          lv[4 * t + 2 * h + 1] = v.y;
        }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dw);
      // dC_i += (dW ⊙ L)·B_j.
#pragma unroll
      for (int e = 0; e < 32; ++e) dw[e] *= lv[e];
      Frag dh, dlo;
      frag_split(dw, dh, dlo);
      sm90::fence_regs(dc);
      sm90::wgmma_fence();
      mma_rm<128>(dc, dh, s.a_b);
      mma_rm<128>(dc, dlo, s.a_b);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dc);
      fence_frag(dh);
      fence_frag(dlo);
    }
    store_rows(f.dc, dc, row0 + ib);
  }
}

__global__ void __launch_bounds__(ssd_sm90::WG, 2)
ssd_bwd_wgmma(const __grid_constant__ BwdArgsA f) {
  extern __shared__ __align__(512) unsigned char smem_raw[];
  const SmemA s(align512(smem_raw));
  const int C = f.cluster, q = f.q, r0 = acc_r0(), c0 = acc_c0();
  const int rank = C > 1 ? (int)sm90::cluster_rank() : 0;
  const int64_t g = blockIdx.x / C;
  // This rank's chunks [lo, hi); every rank has at least one (C <= NC).
  const int lo = rank * f.chunks / C, hi = (rank + 1) * f.chunks / C;
  const bool carry = hi - lo > 1;
  auto cell = [&](int c) { return g * f.chunks + c; };
  auto decay = [&](int c) { return f.di[(cell(c) + 1) * q - 1]; };
  // The published (p, n) fp32 tile, by thread: a thread's accumulator
  // registers 4 k .. 4 k + 3 at float4 k * WG + threadIdx.x, so that a
  // peer reads it in 16 conflict-free vector loads a thread.
  float4* pub = reinterpret_cast<float4*>(s.state) + threadIdx.x;

  // 1. The rank's chunks folded from zero, last to first, and the product
  //    of their decays, published.
  float acc[64], inc[64];
  float dprod = 1.f;
  for (int c = hi - 1; c >= lo; --c) {
    chunk_inc(f, s, cell(c), inc);
    const float d = decay(c);
#pragma unroll
    for (int e = 0; e < 64; ++e)
      acc[e] = c == hi - 1 ? inc[e] : __fadd_rn(__fmul_rn(acc[e], d), inc[e]);
    dprod = c == hi - 1 ? d : __fmul_rn(dprod, d);
  }
#pragma unroll
  for (int k = 0; k < 16; ++k)
    pub[k * ssd_sm90::WG] =
        make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2], acc[4 * k + 3]);
  if (threadIdx.x == 0) s.red[4] = dprod;
  if (C > 1) sm90::cluster_sync(); else __syncthreads();

  // 2. dS leaving the rank's last chunk: dS_final folded through the higher
  //    ranks' tiles, last rank first; rank 0 folds its own tile into ds0.
  const int64_t gs = g * (A_HEAD_DIM * A_STATE);
#pragma unroll
  for (int t = 0; t < 16; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pos = (r0 + 8 * h) * A_STATE + 8 * t + c0;
      const float2 v = __ldg(reinterpret_cast<const float2*>(f.dsf + gs + pos));
      acc[4 * t + 2 * h] = v.x;
      acc[4 * t + 2 * h + 1] = v.y;
    }
  for (int rr = C - 1; rr > rank; --rr) {
    const float d = sm90::ld_dsmem(sm90::map_rank(sm90::smem_u32(s.red + 4),
                                                  rr));
    const uint32_t peer = sm90::map_rank(sm90::smem_u32(pub), rr);
    float4 tile[16];
#pragma unroll
    for (int k = 0; k < 16; ++k)
      tile[k] = ssd_sm90::ld_dsmem4(peer + k * ssd_sm90::WG * 16);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float v[4] = {tile[k].x, tile[k].y, tile[k].z, tile[k].w};
#pragma unroll
      for (int m = 0; m < 4; ++m)
        acc[4 * k + m] = __fadd_rn(__fmul_rn(acc[4 * k + m], d), v[m]);
    }
  }
  if (rank == 0) {
#pragma unroll
    for (int t = 0; t < 16; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = 4 * t + 2 * h;
        const float2 own = *reinterpret_cast<const float2*>(
            reinterpret_cast<const float*>(pub + (e / 4) * ssd_sm90::WG) +
            e % 4);
        *reinterpret_cast<float2*>(f.ds0 + gs + (r0 + 8 * h) * A_STATE +
                                   8 * t + c0) =
            make_float2(__fadd_rn(__fmul_rn(acc[e], dprod), own.x),
                        __fadd_rn(__fmul_rn(acc[e + 1], dprod), own.y));
      }
  }
  if (C > 1) sm90::cluster_sync(); else __syncthreads();

  // 3. The rank's chunks, last to first.
  float ddi_last = set_ds(f, s, cell(hi - 1), acc, carry);
  for (int c = hi - 1; c >= lo; --c) {
    if (c < hi - 1) {
      // dS leaving chunk c: dS leaving chunk c + 1, times its decay, plus
      // its increment.
      chunk_inc(f, s, cell(c + 1), inc);
      const float d = decay(c + 1);
#pragma unroll
      for (int t = 0; t < 16; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int e = 4 * t + 2 * h + k;
            const int pos = (r0 + 8 * h) * A_STATE + 8 * t + c0 + k;
            acc[e] = __fadd_rn(__fmul_rn(s.carry[pos], d), inc[e]);
          }
      ddi_last = set_ds(f, s, cell(c), acc, carry);
    }
    column_pass(f, s, cell(c));
    row_pass(f, s, cell(c), ddi_last);
  }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

cudaError_t launch_a(const BwdArgsA& f, int groups, cudaStream_t stream) {
  // Raised once, so that a launch inside a CUDA-graph capture makes no
  // attribute call; the carveout lets two blocks share an SM.
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_bwd_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
        A_SMEM + A_CARRY_BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_bwd_wgmma,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * f.cluster);
  cfg.blockDim = dim3(ssd_sm90::WG);
  cfg.dynamicSmemBytes = A_SMEM + (f.chunks > f.cluster ? A_CARRY_BYTES : 0);
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  if (f.cluster > 1) {
    attrs[0].id = cudaLaunchAttributeClusterDimension;
    attrs[0].val.clusterDim.x = f.cluster;
    attrs[0].val.clusterDim.y = 1;
    attrs[0].val.clusterDim.z = 1;
    cfg.attrs = attrs;
    cfg.numAttrs = 1;
  }
  const cudaError_t e = cudaLaunchKernelEx(&cfg, ssd_bwd_wgmma, f);
  return e != cudaSuccess ? e : cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// route: ROUTE_A (within route A's limits, a cluster of `cluster` blocks a
// group) or ROUTE_B (one block a group; `cluster` ignored).
extern "C" int ssd_scan_bwd(const void* c, const void* b, const void* l,
                            const void* x, const float* di, const float* dout,
                            const float* states, const float* dy,
                            const float* dsf, float* dc, float* db, float* dl,
                            float* dx, float* ddi, float* ddo, float* ds0,
                            int groups, int chunks, int q, int n, int p,
                            int cb_bf16, int l_bf16, int x_bf16, int route,
                            int cluster, void* stream) {
  if (!geometry_ok(groups, chunks, q, n, p)) return cudaErrorInvalidValue;
  if (route == ROUTE_A) {
    const void* ptrs[] = {c,  b,  l,  x,  di, dout, states, dy,
                          dsf, dc, db, dl, dx, ddi,  ddo,    ds0};
    bool ok = cb_bf16 && !l_bf16 && !x_bf16 && q % A_BLOCK == 0 &&
              n == A_STATE && p == A_HEAD_DIM && cluster >= 1 &&
              cluster <= MAX_CLUSTER && cluster <= chunks &&
              (int64_t)groups * cluster <= INT_MAX;
    for (const void* ptr : ptrs) ok = ok && aligned16(ptr);
    if (!ok) return cudaErrorInvalidValue;
    BwdArgsA f{static_cast<const __nv_bfloat16*>(c),
               static_cast<const __nv_bfloat16*>(b),
               static_cast<const float*>(l),
               static_cast<const float*>(x),
               di, dout, states, dy, dsf, dc, db, dl, dx, ddi, ddo, ds0,
               chunks, q, cluster};
    return launch_a(f, groups, static_cast<cudaStream_t>(stream));
  }
  if (route != ROUTE_B) return cudaErrorInvalidValue;
  BwdArgs f{{c, cb_bf16}, {b, cb_bf16}, {l, l_bf16}, {x, x_bf16},
            di, dout, states, dy, dsf, dc, db, dl, dx, ddi, ddo, ds0,
            chunks, q, n, p};
  return launch(ssd_bwd_route_b, groups, smem_floats(q, n, p) * sizeof(float),
                stream, f);
}
