// Mamba-2 SSD chunked scan for Hopper (sm_90a): the whole carried-state
// scan in one launch (ssd_scan_fused), and the intra-chunk ladder alone
// (ssd_chunk_diag).
//
// Replaces the reference package's TPU kernels
// src/repro/kernels/ssd_chunk/kernel.py::build_ssd_scan_kernel
// (_ssd_scan_body) and ::build_ssd_chunk_kernel (_ssd_chunk_body).  There a
// (groups, chunks) grid walks the chunk dimension in order with the (p, n)
// fp32 state as VMEM scratch, and each grid step holds a whole chunk cell
// and its (Q, Q) score tile in VMEM.  Per chunk, with S the state entering
// it:
//
//   W = round_x((C·Bᵀ) ⊙ L),  y = W·xdt + (C·Sᵀ) ⊙ decay_in,
//   S ← S · decay_in[Q-1] + round_x(xdt ⊙ decay_out)ᵀ · B.
//
// With `states`, S entering each chunk is written out (the residual the
// backward walk replays); s0 seeds chunk 0 and s_final takes S after the
// last chunk.  The diag form is one chunk a cell over flat (batch x chunk
// x head) cells, with no state.
//
// Numerics follow the reference kernel: C, B and L are read as fp32
// (bfloat16 widens exactly), products accumulate in fp32, W and
// xdt ⊙ decay_out are rounded to xdt's dtype (round_x) before their
// products, y (W·xdt and the state term summed in fp32) is rounded once to
// xdt's dtype; the state stays fp32.  Never TF32.  No atomics: every output
// element has one writer and every sum a fixed order, so two runs give the
// same bits.  Two routes, chosen per call in kernel.py (choose_fwd_route),
// which counts them:
//
// (A) bf16 C and B, fp32 L and xdt, Q a multiple of 64, n = 128, p = 64,
//     16-byte aligned operands, and for the scan at most 8 chunks a group:
//     mamba2's serving and training paths.  What bounds it on the H100:
//     bytes.  At the serving shape (96 groups x 4 chunks of 256) about
//     0.21 GB (0.062 ms at 3.35 TB/s; L is half of it) against about 35
//     GFLOP of bf16 wgmma in the pieces below (0.036 ms at 989 TFLOP/s).
//     The design:
//     * Only the state leg reads the carried state, so a group's chunks
//       are split over a thread-block cluster of NC blocks, one chunk a
//       rank (384 blocks at serving, 768 at training; a scan of more than
//       8 chunks, the portable cluster size, takes route B).  Each rank
//       first computes its chunk's increment inc = round_x(xdt ⊙
//       decay_out)ᵀ·B and publishes that (p, n) fp32 tile and the chunk's
//       decay in its shared memory.  After a cluster barrier each rank
//       folds s0 through the lower ranks' tiles over distributed shared
//       memory, rank 0 first (one multiply and one add each, no FMA: the
//       reference's order); the last rank folds its own tile too into
//       s_final.  A second cluster barrier frees the tiles.  The diag
//       form runs a block a cell.
//     * Every product runs on wgmma, fp32 sums.  C and B go in exactly;
//       every fp32 operand is split into three bf16 pieces (hi, lo = what
//       hi leaves out, lo2 = what both leave out): at the kernel's 1e-4
//       bound two pieces are not enough, one product's 2^-16 alone takes
//       y to about twice the bound at the serving shape.  The increment
//       and C·Sᵀ run once a piece (three passes), W·xdt six times (the
//       piece pairs whose indices sum to at most 2).  In 64-row windows
//       (ssd_sm90.cuh): the increment over the column windows j (B_j and
//       xdt_j ⊙ decay_out staged); y_off = (C_i·Sᵀ) ⊙ decay_in, S in
//       three windows; and per row window i the ladder over the column
//       windows j: the scores C_i·B_jᵀ into the accumulator, ⊙ L_ij read
//       from global memory in the accumulator layout (whole 32-byte
//       sectors; L is read whole, the blocks above the diagonal too, as
//       the reference multiplies by all of it), split in registers into
//       three A fragments, y_diag += W·xdt_j; y = y_diag + y_off stored
//       once.
//     * Every wgmma group is fenced, committed and waited on in the
//       routine that issues it, over straight-line code: the increment
//       waits on each window's products before the next (the loop over
//       windows holds no product in flight), and the routines that own
//       accumulators are inlined.  So ptxas takes the groups as written:
//       it injects no warpgroup fence of its own and serializes no wgmma
//       (tests/test_torch_ssd_fwd_routes.py checks its report).  A walk
//       of several chunks a rank in the same kernel made ptxas inject
//       fences there and serialize every wgmma of the kernel, the
//       one-chunk path's too: that is why a scan of more than 8 chunks
//       takes route B.
//     * A block is two warpgroups with the chunk's windows resident: each
//       stages every other B_j window (kept from the increment on) and
//       xdt_j window, computes 64 of the increment's 128 columns, and
//       ladders every other row window i in a C_i window of its own.  The
//       state's windows share the xdt_j windows' memory, so the scan
//       first computes every y_off and stores it to y, then stages the
//       xdt_j windows and adds y_diag onto y.  193 KB of shared memory, one
//       block an SM.  The block stages its windows with its own 16-byte
//       loads, all of a staging's loads issued before its first store
//       (the fp32 operands are split on their way in); while a tile
//       computes, the rows of L two tiles on and the next rows of C are
//       requested into L2.
//     What still bounds it (on an H100 SXM at 700 W about 0.17 ms at the
//     serving shape, 0.31 at training, 0.09 for the diag form): the
//     passes of a block run in series, each its own chain of loads and
//     products, and the ladder's tiles wait on their rows of L; one block
//     an SM at about three waves of clusters.  Measured slower: one
//     warpgroup a block with the windows resident, or streamed for each
//     tile at two blocks an SM; asking L2 for the chunk's whole L at the
//     start.  No faster: issuing a tile's scores and L during the W·xdt
//     before it, loading s0 during the first cluster barrier, or a
//     warpgroup's two windows at once.
// (B) everything else (fp32 C and B, bf16 L or xdt, other Q, n or p): one
//     256-thread block a group walks its chunks in a loop, the state S in
//     shared memory.  Per chunk, rows go in blocks of RB and the columns of
//     the ladder in slices of RB, so the (Q, Q) score tile is never staged
//     whole and B and xdt stream through shared memory a slice at a time
//     (read again through L2 for each row block); products are fp32 4x4
//     register micro-tiles on CUDA cores (block_mm), and the state update
//     follows a barrier after the last row block (every row has read the
//     entering state).  The diag form runs one block a cell.  Bound by its
//     fp32 CUDA-core products and by one block a group (96 of 132 SMs at
//     the serving shape, each walking its chunks in series).

#include <climits>
#include <initializer_list>

#include "ssd_common.cuh"
#include "ssd_sm90.cuh"

namespace {

using namespace ssd;

enum { ROUTE_A = 0, ROUTE_B = 1 };

// ---------------------------------------------------------------------------
// Route B: one block a group, fp32 CUDA-core products.
// ---------------------------------------------------------------------------

constexpr int RB = 64;  // rows per block step and columns per slice

struct FwdArgs {
  Operand c, b, l, x;     // (cells, Q, n) x2, (cells, Q, Q), (cells, Q, p)
  const float* di;        // (cells, Q) decay from chunk start into the row
  const float* dout;      // (cells, Q) decay from the row to chunk end
  const float* s0;        // (G, p, n)
  void* y;                // (cells, Q, p), xdt's dtype
  float* s_final;         // (G, p, n)
  float* states;          // (cells, p, n) or null
  int chunks, q, n, p;
};

size_t smem_floats(bool scan, int q, int n, int p) {
  const size_t ldn = n | 1, ldp = p | 1, ldw = RB | 1;
  return (scan ? p * ldn + 2 * (size_t)q : 0) + 2 * RB * ldn + RB * ldp +
         RB * ldw + (size_t)RB * p;
}

template <bool SCAN>
__global__ void __launch_bounds__(NT) ssd_fwd_kernel(FwdArgs f) {
  extern __shared__ float smem[];
  const int q = f.q, n = f.n, p = f.p;
  const int ldn = n | 1, ldp = p | 1, ldw = RB | 1;
  float* sS = smem;                            // p x ldn: the carried state
  float* sC = sS + (SCAN ? p * ldn : 0);       // RB x ldn: C rows
  float* sB = sC + RB * ldn;                   // RB x ldn: B slice
  float* sX = sB + RB * ldn;                   // RB x ldp: xdt slice
  float* sW = sX + RB * ldp;                   // RB x ldw: W tile
  float* sY = sW + RB * ldw;                   // RB x p: y_diag rows
  float* sDi = sY + RB * p;                    // Q
  float* sDo = sDi + q;                        // Q
  const int xb = f.x.bf16;
  const int64_t g = blockIdx.x;
  const int chunks = SCAN ? f.chunks : 1;
  if (SCAN)
    for (int i = threadIdx.x; i < p * n; i += NT)
      sS[(i / n) * ldn + i % n] = f.s0[g * p * n + i];
  for (int ci = 0; ci < chunks; ++ci) {
    const int64_t cell = g * chunks + ci;
    const int64_t cq = cell * q;  // the cell's first row
    __syncthreads();  // s0 loaded, or the previous chunk's update done
    if (SCAN) {
      if (f.states)
        for (int i = threadIdx.x; i < p * n; i += NT)
          f.states[cell * p * n + i] = sS[(i / n) * ldn + i % n];
      for (int i = threadIdx.x; i < q; i += NT) {
        sDi[i] = f.di[cq + i];
        sDo[i] = f.dout[cq + i];
      }
    }
    for (int rb = 0; rb < q; rb += RB) {
      const int rows = min(RB, q - rb);
      __syncthreads();  // the previous row block's readers are done
      load_tile(sC, ldn, f.c, (cq + rb) * n, rows, n, n);
      for (int i = threadIdx.x; i < rows * p; i += NT) sY[i] = 0.f;
      for (int jb = 0; jb < q; jb += RB) {
        const int cols = min(RB, q - jb);
        __syncthreads();  // the previous slice's readers are done
        load_tile(sB, ldn, f.b, (cq + jb) * n, cols, n, n);
        load_tile(sX, ldp, f.x, (cq + jb) * p, cols, p, p);
        __syncthreads();
        // W = round_x((C_rows · B_colsᵀ) ⊙ L)
        block_mm(
            rows, cols, n, [&](int m, int k) { return sC[m * ldn + k]; },
            [&](int j, int k) { return sB[j * ldn + k]; },
            [&](int m, int j, float s) {
              sW[m * ldw + j] =
                  round_to(s * f.l[(cq + rb + m) * q + jb + j], xb);
            });
        __syncthreads();
        // y_diag += W · xdt_cols
        block_mm(
            rows, p, cols, [&](int m, int k) { return sW[m * ldw + k]; },
            [&](int c, int k) { return sX[k * ldp + c]; },
            [&](int m, int c, float v) { sY[m * p + c] += v; });
      }
      if (SCAN) {
        // y = y_diag + (C_rows · Sᵀ) ⊙ decay_in, by the owners of sY.
        block_mm(
            rows, p, n, [&](int m, int k) { return sC[m * ldn + k]; },
            [&](int c, int k) { return sS[c * ldn + k]; },
            [&](int m, int c, float v) {
              store(f.y, xb, (cq + rb + m) * p + c,
                    sY[m * p + c] + v * sDi[rb + m]);
            });
      } else {
        __syncthreads();
        for (int i = threadIdx.x; i < rows * p; i += NT)
          store(f.y, xb, (cq + rb) * p + i, sY[i]);
      }
    }
    if (SCAN) {
      // S ← S · decay_in[Q-1] + round_x(xdt ⊙ decay_out)ᵀ · B
      __syncthreads();  // every row has read the entering state
      const float dlast = sDi[q - 1];
      for (int i = threadIdx.x; i < p * n; i += NT)
        sS[(i / n) * ldn + i % n] *= dlast;
      for (int jb = 0; jb < q; jb += RB) {
        const int cols = min(RB, q - jb);
        __syncthreads();
        load_tile(sB, ldn, f.b, (cq + jb) * n, cols, n, n);
        for (int i = threadIdx.x; i < cols * p; i += NT) {
          const int j = i / p, c = i - j * p;
          sX[j * ldp + c] =
              round_to(f.x[(cq + jb + j) * p + c] * sDo[jb + j], xb);
        }
        __syncthreads();
        block_mm(
            p, n, cols, [&](int c, int k) { return sX[k * ldp + c]; },
            [&](int e, int k) { return sB[k * ldn + e]; },
            [&](int c, int e, float v) { sS[c * ldn + e] += v; });
      }
    }
  }
  if (SCAN) {
    __syncthreads();
    for (int i = threadIdx.x; i < p * n; i += NT)
      f.s_final[g * p * n + i] = sS[(i / n) * ldn + i % n];
  }
}


// ---------------------------------------------------------------------------
// Route A: a cluster of blocks a group, two warpgroups a block, wgmma.
// ---------------------------------------------------------------------------

constexpr int A_BLOCK = 64;      // rows of a window; Q is a multiple of it
constexpr int A_STATE = 128;     // n
constexpr int A_HEAD_DIM = 64;   // p
constexpr int MAX_CLUSTER = 8;   // the portable thread-block cluster size
constexpr int A_THREADS = 2 * ssd_sm90::WG;
// Shared memory of a route-A block, after 512 bytes of alignment slack
// (the 64-byte swizzle repeats every 512): the chunk's Q / 64 B_j windows;
// its xdt_j split windows, whose memory the scan's state region (S in
// three split windows, and before it the published fp32 tile) takes until
// the xdt_j windows are staged; a C_i window a warpgroup; and 64 bytes of
// the published decay.
constexpr int A_STATE_WINDOW = A_HEAD_DIM * A_STATE * 2;
constexpr int A_STATE_BYTES = 3 * A_STATE_WINDOW;            // hi, lo, lo2
constexpr int A_NB_BYTES = A_BLOCK * A_STATE * 2;
constexpr int A_X_WINDOW = A_BLOCK * A_HEAD_DIM * 2;
constexpr int A_NX_BYTES = 3 * A_X_WINDOW;                   // hi, lo, lo2
constexpr int A_PUB_BYTES = A_HEAD_DIM * A_STATE * 4;
constexpr int A_WINDOWS = Q_MAX / A_BLOCK;

// The xdt region of `windows` windows, which the scan's state region
// shares.
__host__ __device__ constexpr int a_x_region(bool scan, int windows) {
  return scan && windows * A_NX_BYTES < A_STATE_BYTES ? A_STATE_BYTES
                                                     : windows * A_NX_BYTES;
}

constexpr int a_smem(bool scan, int windows) {
  return 512 + windows * A_NB_BYTES + a_x_region(scan, windows) +
         2 * A_NB_BYTES + 64;
}
static_assert(A_STATE_BYTES >= A_PUB_BYTES, "the published fp32 tile");
static_assert(a_smem(true, A_WINDOWS) <= 232448, "a block fits");

struct FwdArgsA {
  const __nv_bfloat16 *c, *b;  // (cells, Q, n)
  const float* l;              // (cells, Q, Q)
  const float* x;              // (cells, Q, p)
  const float *di, *dout;      // (cells, Q)
  const float* s0;             // (G, p, n)
  float* y;                    // (cells, Q, p)
  float* s_final;              // (G, p, n)
  float* states;               // (cells, p, n) or null
  int chunks, q;
};

struct SmemA {
  unsigned char *b, *x, *state, *c;  // c: the first warpgroup's C_i window
  float* red;    // [4]: the published decay
  __device__ SmemA(unsigned char* base, bool scan, int windows)
      : b(base),
        x(b + windows * A_NB_BYTES),
        state(x),
        c(x + a_x_region(scan, windows)),
        red(reinterpret_cast<float*>(c + 2 * A_NB_BYTES)) {}
};

__device__ __forceinline__ uint32_t addr(const unsigned char* p) {
  return sm90::smem_u32(p);
}

__device__ __forceinline__ unsigned char* align512(unsigned char* raw) {
  const uint32_t a = sm90::smem_u32(raw);
  return raw + (((a + 511) & ~511u) - a);
}

// A thread's warpgroup, and its accumulator rows (r0, r0 + 8) and first
// column c0.
__device__ __forceinline__ int wg_id() { return threadIdx.x / ssd_sm90::WG; }
__device__ __forceinline__ int acc_r0() {
  return 16 * (threadIdx.x % ssd_sm90::WG / 32) + (threadIdx.x % 32) / 4;
}
__device__ __forceinline__ int acc_c0() { return 2 * (threadIdx.x % 4); }

// A barrier over the thread's warpgroup.
__device__ __forceinline__ void wg_sync() {
  sm90::bar_sync(1 + wg_id(), ssd_sm90::WG);
}

// Asks L2 for 64 rows of 256 bytes from p, `ld` elements of T apart (two
// threads of the warpgroup a row), for a later load: a window's rows of
// C, B or xdt, or a tile's rows of L.
template <typename T>
__device__ __forceinline__ void prefetch_rows(const T* p, int64_t ld) {
  const int t = threadIdx.x % ssd_sm90::WG;
  ssd_sm90::prefetch_l2(reinterpret_cast<const char*>(p + (t / 2) * ld) +
                        (t % 2) * 128);
}

// Stages rows [r, r + 64) of a chunk, by the thread's warpgroup: where m is
// given, the bf16 (Q, n) window of m (C or B) at w, and where v is given,
// the (Q, p) rows of v (xdt, times `scale` where given) in three split
// windows at wp.
__device__ __forceinline__ void stage(unsigned char* w, const __nv_bfloat16* m,
                                      unsigned char* wp, const float* v,
                                      int64_t r, const float* scale) {
  ssd_sm90::Bf16Rows<A_STATE> mr;
  ssd_sm90::F32Rows<A_HEAD_DIM> vr;
  if (m != nullptr) mr.load(m + r * A_STATE, A_STATE);
  if (v != nullptr) vr.load(v + r * A_HEAD_DIM, A_HEAD_DIM, scale);
  wg_sync();  // the windows' previous readers are done
  if (m != nullptr) mr.store(w);
  if (v != nullptr) vr.store<3>(wp);
  sm90::fence_proxy_async();  // generic writes, visible to wgmma
  wg_sync();
}

// Stages the chunk's windows j, each warpgroup every other one: B_j where
// m is given, and xdt_j (times decay_out where scale is given) in three
// pieces.  Begins and ends with the block's barrier: both warpgroups read
// every window.
__device__ __forceinline__ void stage_windows(const FwdArgsA& f, const SmemA& s,
                              const __nv_bfloat16* m, int64_t row0,
                              const float* scale) {
  const int q = f.q;
  __syncthreads();  // the windows' previous readers are done
  for (int jb = wg_id() * A_BLOCK; jb < q; jb += 2 * A_BLOCK) {
    const int w = jb / A_BLOCK;
    stage(s.b + w * A_NB_BYTES, m, s.x + w * A_NX_BYTES, f.x, row0 + jb,
          scale != nullptr ? scale + row0 + jb : nullptr);
    if (jb + 2 * A_BLOCK < q) {  // the warpgroup's next windows
      if (m != nullptr)
        prefetch_rows(m + (row0 + jb + 2 * A_BLOCK) * A_STATE, A_STATE);
      prefetch_rows(f.x + (row0 + jb + 2 * A_BLOCK) * A_HEAD_DIM,
                    A_HEAD_DIM);
    }
  }
  __syncthreads();  // the other warpgroup's windows
}

// A thread's part of a 64 x 64 accumulator into the rows from `row0` of
// the row-major fp32 (cells x Q, p) output; with `add`, onto what the
// thread stored there before.
__device__ __forceinline__ void store_rows(float* out, float (&x)[32],
                                           int64_t row0, bool add) {
  const int r0 = acc_r0(), c0 = acc_c0();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float2* row = reinterpret_cast<float2*>(
        out + (row0 + r0 + 8 * h) * A_HEAD_DIM + c0);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      float2 v = make_float2(x[4 * t + 2 * h], x[4 * t + 2 * h + 1]);
      if (add) {
        const float2 o = row[4 * t];
        v = make_float2(v.x + o.x, v.y + o.y);
      }
      row[4 * t] = v;
    }
  }
}

// The 64 x 64 tile of a chunk's L at rows ib, columns jb, in the
// accumulator layout: every warp load covers whole 32-byte sectors.
__device__ __forceinline__ void load_l(float (&lv)[32], const float* L,
                                       int ib, int jb, int q) {
  const int r0 = acc_r0(), c0 = acc_c0();
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(
          L + (int64_t)(ib + r0 + 8 * h) * q + jb + 8 * t + c0));
      lv[4 * t + 2 * h] = v.x;
      lv[4 * t + 2 * h + 1] = v.y;
    }
}

// y_off = (C_i·Sᵀ) ⊙ decay_in of one row window into yo, S in the state
// region's three windows; di holds the window's decays.
__device__ __forceinline__ void state_leg(float (&yo)[32], uint32_t a_c,
                                          uint32_t a_state, const float* di) {
  using namespace ssd_sm90;
  const int r0 = acc_r0();
  zero(yo);
  sm90::fence_regs(yo);
  sm90::wgmma_fence();
#pragma unroll
  for (int pc = 0; pc < 3; ++pc)
    mma_kk<64, 8>(yo, a_c, a_state + pc * A_STATE_WINDOW);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(yo);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float d = di[r0 + 8 * h];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      yo[4 * t + 2 * h] *= d;
      yo[4 * t + 2 * h + 1] *= d;
    }
  }
}

// y_diag of the row window ib (C_i at a_c) into y, over the column windows
// j: scores = C_i·B_jᵀ (exact) with L_ij loaded while it runs; W = scores
// ⊙ L (round_x is the identity for fp32 xdt), split into three A
// fragments; y_diag += W·xdt_j over the six piece pairs.  next_ib: the row
// window the warpgroup takes next (its C rows and first tiles of L are
// requested into L2).
__device__ __forceinline__ void ladder_row(const FwdArgsA& f, const SmemA& s, uint32_t a_c,
                           int64_t row0, int ib, int next_ib,
                           float (&y)[32]) {
  using namespace ssd_sm90;
  const int q = f.q;
  const float* L = f.l + row0 * q;
  zero(y);
  for (int jb = 0; jb < q; jb += A_BLOCK) {
    const int w = jb / A_BLOCK;
    // Asks L2 for what comes next: L two tiles on, the next row window's
    // C.
    const int jl = jb + 2 * A_BLOCK;
    if (jl < q)
      prefetch_rows(L + (int64_t)ib * q + jl, q);
    else if (jl - q < q && next_ib < q)
      prefetch_rows(L + (int64_t)next_ib * q + jl - q, q);
    if (jb + A_BLOCK >= q && next_ib < q)
      prefetch_rows(f.c + (row0 + next_ib) * A_STATE, A_STATE);
    float w_ij[32], lv[32];
    zero(w_ij);
    sm90::fence_regs(w_ij);
    sm90::wgmma_fence();
    mma_kk<64, 8>(w_ij, a_c, addr(s.b) + w * A_NB_BYTES);
    sm90::wgmma_commit();
    load_l(lv, L, ib, jb, q);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(w_ij);
#pragma unroll
    for (int e = 0; e < 32; ++e) w_ij[e] *= lv[e];
    Frag w0, w1, w2;
    frag_split3(w_ij, w0, w1, w2);
    const uint32_t a_x = addr(s.x) + w * A_NX_BYTES;
    sm90::fence_regs(y);
    sm90::wgmma_fence();
    mma_rm<64>(y, w0, a_x);
    mma_rm<64>(y, w0, a_x + A_X_WINDOW);
    mma_rm<64>(y, w1, a_x);
    mma_rm<64>(y, w0, a_x + 2 * A_X_WINDOW);
    mma_rm<64>(y, w1, a_x + A_X_WINDOW);
    mma_rm<64>(y, w2, a_x);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(y);
    fence_frag(w0);
    fence_frag(w1);
    fence_frag(w2);
  }
}

// The warpgroup's 64 columns of inc = round_x(xdt ⊙ decay_out)ᵀ·B of one
// chunk, (p, 64) in the accumulator layout: every B_j window (which stays
// for the chunk's y) and xdt_j ⊙ decay_out split window staged first,
// each read MN-major (xdt ⊙ decay_out as A).
__device__ __forceinline__ void chunk_inc(const FwdArgsA& f, const SmemA& s,
                                          int64_t cell, float (&inc)[32]) {
  using namespace ssd_sm90;
  const int q = f.q, wg = wg_id();
  stage_windows(f, s, f.b, cell * q, f.dout);
  zero(inc);
  for (int w = 0; w < q / A_BLOCK; ++w) {
    sm90::fence_regs(inc);
    sm90::wgmma_fence();
#pragma unroll
    for (int pc = 0; pc < 3; ++pc)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<64, 1, 1>(
            inc, mnmaj(addr(s.x) + w * A_NX_BYTES + pc * A_X_WINDOW, kk),
            mnmaj(addr(s.b) + w * A_NB_BYTES + 2 * wg * PANEL, kk));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(inc);
  }
  __syncthreads();  // both warpgroups' products have read the xdt windows
}

// Makes st (a thread's part of its warpgroup's columns of the (p, n)
// accumulator layout) the state entering chunk `cell`: written to
// `states` where asked, and split into the three windows of the state
// region.  Asks L2 for the chunk's first tile.
__device__ __forceinline__ void set_state(const FwdArgsA& f, const SmemA& s,
                                          int64_t cell,
                                          const float (&st)[32]) {
  const int r0 = acc_r0(), c0 = acc_c0(), col0 = wg_id() * A_BLOCK;
  prefetch_rows(f.c + cell * f.q * A_STATE, A_STATE);
  prefetch_rows(f.l + cell * f.q * f.q, f.q);
  float* out = f.states ? f.states + cell * (A_HEAD_DIM * A_STATE) : nullptr;
  __syncthreads();  // the state region's readers are done
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = 4 * t + 2 * h, col = col0 + 8 * t + c0;
      const int pos = (r0 + 8 * h) * A_STATE + col;
      const float2 v = make_float2(st[e], st[e + 1]);
      if (out != nullptr) *reinterpret_cast<float2*>(out + pos) = v;
      ssd_sm90::store_pieces<3>(s.state + ssd_sm90::swz(r0 + 8 * h, col),
                                A_STATE_WINDOW, v.x, v.y);
    }
  sm90::fence_proxy_async();
  __syncthreads();
}

// y of one chunk, each warpgroup every other row window: with SCAN first
// the state legs, stored to y (S's windows share the xdt windows'
// memory); then the xdt windows staged (and the B windows, unless the
// chunk's are in place from its increment); then the ladders, y = y_diag
// + the stored state leg.
template <bool SCAN>
__device__ __forceinline__ void chunk_y(const FwdArgsA& f, const SmemA& s, int64_t cell,
                        bool b_in_place) {
  const int q = f.q, wg = wg_id();
  const int64_t row0 = cell * q;
  unsigned char* cw = s.c + wg * A_NB_BYTES;
  if (SCAN) {
    for (int ib = wg * A_BLOCK; ib < q; ib += 2 * A_BLOCK) {
      stage(cw, f.c, nullptr, nullptr, row0 + ib, nullptr);
      float yo[32];
      state_leg(yo, addr(cw), addr(s.state), f.di + row0 + ib);
      store_rows(f.y, yo, row0 + ib, false);
    }
    __syncthreads();  // S's readers are done
  }
  stage_windows(f, s, b_in_place ? nullptr : f.b, row0, nullptr);
  for (int ib = wg * A_BLOCK; ib < q; ib += 2 * A_BLOCK) {
    stage(cw, f.c, nullptr, nullptr, row0 + ib, nullptr);
    float y[32];
    ladder_row(f, s, addr(cw), row0, ib, ib + 2 * A_BLOCK, y);
    store_rows(f.y, y, row0 + ib, SCAN);
  }
}

template <bool SCAN>
__global__ void __launch_bounds__(A_THREADS, 1)
ssd_fwd_wgmma(const __grid_constant__ FwdArgsA f) {
  extern __shared__ __align__(512) unsigned char smem_raw[];
  const SmemA s(align512(smem_raw), SCAN, f.q / A_BLOCK);
  if constexpr (!SCAN) {
    chunk_y<false>(f, s, blockIdx.x, false);
    return;
  }
  // A cluster of f.chunks blocks a group, rank r on chunk r.
  const int C = f.chunks, q = f.q, r0 = acc_r0(), c0 = acc_c0();
  const int col0 = wg_id() * A_BLOCK;  // the warpgroup's state columns
  const int rank = C > 1 ? (int)sm90::cluster_rank() : 0;
  const int64_t g = blockIdx.x / C, cell = blockIdx.x;
  // The published (p, n) fp32 tile, by thread: a thread's accumulator
  // registers 4 k .. 4 k + 3 at float4 k * A_THREADS + threadIdx.x, so
  // that a peer reads it in 8 conflict-free vector loads a thread.
  float4* pub = reinterpret_cast<float4*>(s.state) + threadIdx.x;

  // 1. The chunk's increment and its decay, published.
  float acc[32];
  const float dlast = f.di[(cell + 1) * q - 1];
  chunk_inc(f, s, cell, acc);
#pragma unroll
  for (int k = 0; k < 8; ++k)
    pub[k * A_THREADS] =
        make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2], acc[4 * k + 3]);
  if (threadIdx.x == 0) s.red[4] = dlast;
  if (C > 1) sm90::cluster_sync(); else __syncthreads();

  // 2. S entering the chunk: s0 folded through the lower ranks' tiles,
  //    rank 0 first; the last rank folds its own tile too into s_final.
  const int64_t gs = g * (A_HEAD_DIM * A_STATE);
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pos = (r0 + 8 * h) * A_STATE + col0 + 8 * t + c0;
      const float2 v = __ldg(reinterpret_cast<const float2*>(f.s0 + gs + pos));
      acc[4 * t + 2 * h] = v.x;
      acc[4 * t + 2 * h + 1] = v.y;
    }
  for (int rr = 0; rr < rank; ++rr) {
    const float d = sm90::ld_dsmem(sm90::map_rank(sm90::smem_u32(s.red + 4),
                                                  rr));
    const uint32_t peer = sm90::map_rank(sm90::smem_u32(pub), rr);
    float4 tile[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      tile[k] = ssd_sm90::ld_dsmem4(peer + k * A_THREADS * 16);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float v[4] = {tile[k].x, tile[k].y, tile[k].z, tile[k].w};
#pragma unroll
      for (int m = 0; m < 4; ++m)
        acc[4 * k + m] = __fadd_rn(__fmul_rn(acc[4 * k + m], d), v[m]);
    }
  }
  if (rank == C - 1) {
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = 4 * t + 2 * h;
        const float2 own = *reinterpret_cast<const float2*>(
            reinterpret_cast<const float*>(pub + (e / 4) * A_THREADS) + e % 4);
        *reinterpret_cast<float2*>(f.s_final + gs + (r0 + 8 * h) * A_STATE +
                                   col0 + 8 * t + c0) =
            make_float2(__fadd_rn(__fmul_rn(acc[e], dlast), own.x),
                        __fadd_rn(__fmul_rn(acc[e + 1], dlast), own.y));
      }
  }
  if (C > 1) sm90::cluster_sync(); else __syncthreads();

  // 3. The chunk's y, its B windows kept from step 1.
  set_state(f, s, cell, acc);
  chunk_y<true>(f, s, cell, true);
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

template <bool SCAN>
cudaError_t launch_a(const FwdArgsA& f, int blocks, cudaStream_t stream) {
  const auto kernel = ssd_fwd_wgmma<SCAN>;
  // Raised once, so that a launch inside a CUDA-graph capture makes no
  // attribute call.
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      a_smem(SCAN, A_WINDOWS));
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(A_THREADS);
  cfg.dynamicSmemBytes = a_smem(SCAN, f.q / A_BLOCK);
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  if (SCAN && f.chunks > 1) {
    attrs[0].id = cudaLaunchAttributeClusterDimension;
    attrs[0].val.clusterDim.x = f.chunks;
    attrs[0].val.clusterDim.y = 1;
    attrs[0].val.clusterDim.z = 1;
    cfg.attrs = attrs;
    cfg.numAttrs = 1;
  }
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, f);
  return e != cudaSuccess ? e : cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Route A's limits: bf16 C / B, fp32 L and xdt, whole windows, n and p
// exactly, 16-byte aligned operands.
bool route_a_ok(int cb_bf16, int l_bf16, int x_bf16, int q, int n, int p,
                std::initializer_list<const void*> ptrs) {
  bool ok = cb_bf16 && !l_bf16 && !x_bf16 && q % A_BLOCK == 0 &&
            n == A_STATE && p == A_HEAD_DIM;
  for (const void* ptr : ptrs) ok = ok && aligned16(ptr);
  return ok;
}

}  // namespace

// route: ROUTE_A (within route A's limits and at most MAX_CLUSTER chunks:
// a cluster of a block a chunk for each group) or ROUTE_B (one block a
// group).
extern "C" int ssd_scan_fused(const void* c, const void* b, const void* l,
                              const void* x, const float* di,
                              const float* dout, const float* s0, void* y,
                              float* s_final, float* states, int groups,
                              int chunks, int q, int n, int p, int cb_bf16,
                              int l_bf16, int x_bf16, int route,
                              void* stream) {
  if (!geometry_ok(groups, chunks, q, n, p)) return cudaErrorInvalidValue;
  if (route == ROUTE_A) {
    if (!route_a_ok(cb_bf16, l_bf16, x_bf16, q, n, p,
                    {c, b, l, x, di, dout, s0, y, s_final, states}) ||
        chunks > MAX_CLUSTER || (int64_t)groups * chunks > INT_MAX)
      return cudaErrorInvalidValue;
    FwdArgsA f{static_cast<const __nv_bfloat16*>(c),
               static_cast<const __nv_bfloat16*>(b),
               static_cast<const float*>(l),
               static_cast<const float*>(x),
               di, dout, s0, static_cast<float*>(y), s_final, states,
               chunks, q};
    return launch_a<true>(f, groups * chunks,
                          static_cast<cudaStream_t>(stream));
  }
  if (route != ROUTE_B) return cudaErrorInvalidValue;
  FwdArgs f{{c, cb_bf16}, {b, cb_bf16}, {l, l_bf16}, {x, x_bf16},
            di, dout, s0, y, s_final, states, chunks, q, n, p};
  return launch(ssd_fwd_kernel<true>, groups,
                smem_floats(true, q, n, p) * sizeof(float), stream, f);
}

extern "C" int ssd_chunk_diag(const void* c, const void* b, const void* l,
                              const void* x, void* y, int groups, int q,
                              int n, int p, int cb_bf16, int l_bf16,
                              int x_bf16, int route, void* stream) {
  if (!geometry_ok(groups, 1, q, n, p)) return cudaErrorInvalidValue;
  if (route == ROUTE_A) {
    if (!route_a_ok(cb_bf16, l_bf16, x_bf16, q, n, p, {c, b, l, x, y}))
      return cudaErrorInvalidValue;
    FwdArgsA f{static_cast<const __nv_bfloat16*>(c),
               static_cast<const __nv_bfloat16*>(b),
               static_cast<const float*>(l),
               static_cast<const float*>(x),
               nullptr, nullptr, nullptr, static_cast<float*>(y), nullptr,
               nullptr, 1, q};
    return launch_a<false>(f, groups, static_cast<cudaStream_t>(stream));
  }
  if (route != ROUTE_B) return cudaErrorInvalidValue;
  FwdArgs f{{c, cb_bf16}, {b, cb_bf16}, {l, l_bf16}, {x, x_bf16},
            nullptr, nullptr, nullptr, y, nullptr, nullptr, 1, q, n, p};
  return launch(ssd_fwd_kernel<false>, groups,
                smem_floats(false, q, n, p) * sizeof(float), stream, f);
}
