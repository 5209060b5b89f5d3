// Mamba-2 SSD chunked scan for Hopper (sm_90a): the whole carried-state
// scan in one launch (ssd_scan_fused), and the intra-chunk ladder alone
// (ssd_chunk_diag), sharing one kernel body.
//
// Replaces the reference package's TPU kernels
// src/repro/kernels/ssd_chunk/kernel.py::build_ssd_scan_kernel
// (_ssd_scan_body) and ::build_ssd_chunk_kernel (_ssd_chunk_body).  There a
// (groups, chunks) grid walks the chunk dimension in order with the (p, n)
// fp32 state as VMEM scratch, and each grid step holds a whole chunk cell
// and its (Q, Q) score tile in VMEM.  Here one thread block owns a group
// (batch x head) and walks its chunks in a loop, the state S in shared
// memory.  Per chunk, rows go in blocks of RB and the columns of the
// ladder in slices of RB, so the (Q, Q) score tile (256 KB fp32 at Q 256)
// is never staged whole and B and xdt stream through shared memory a
// slice at a time (read again through L2 for each row block):
//
//   W      = round_x((C_rows · B_colsᵀ) ⊙ L)       scores in fp32
//   y_rows = Σ_cols W · xdt_cols + (C_rows · Sᵀ) ⊙ decay_in
//
// then, after a barrier (every row has read the entering state):
//
//   S ← S · decay_in[Q-1] + round_x(xdt ⊙ decay_out)ᵀ · B
//
// With `states`, S entering each chunk is written out (the residual the
// backward walk replays); s0 seeds chunk 0 and s_final takes S after the
// last chunk, one chunk included.  The diag form is one chunk per block
// over flat (batch x chunk x head) groups, with no state.
//
// Numerics follow the reference kernel: C, B and L are read as fp32
// (bfloat16 widens exactly), products accumulate in fp32, W and
// xdt ⊙ decay_out are rounded to xdt's dtype (round_x) before their
// products, y is stored in xdt's dtype; the state stays fp32.  C/B, L and
// xdt may each be float32 or bfloat16 (the model passes bf16 C/B with
// fp32 L and xdt).
//
// What bounds it on the H100 at the serving shape (96 groups x 4 chunks,
// Q 256, n 128, p 64, the model's dtypes): about 0.2 GB read and written
// (~0.06 ms at 3.35 TB/s) against ~6.5 GFLOP whose operands include fp32
// (W · xdt, the state terms: ~0.1 ms at the 67 TFLOP/s fp32 rate), so the
// least time is set by operations.  This simple design is far from it:
// fp32 products on CUDA cores from shared memory (4x4 register
// micro-tiles), one block per group, so only 96 of 132 SMs work and each
// walks its chunks in series.  Tensor-core products (wgmma), TMA loads
// and splitting a group's walk over several blocks are later work.

#include "ssd_common.cuh"

namespace {

using namespace ssd;

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

}  // namespace

extern "C" int ssd_scan_fused(const void* c, const void* b, const void* l,
                              const void* x, const float* di,
                              const float* dout, const float* s0, void* y,
                              float* s_final, float* states, int groups,
                              int chunks, int q, int n, int p, int cb_bf16,
                              int l_bf16, int x_bf16, void* stream) {
  if (!geometry_ok(groups, chunks, q, n, p)) return cudaErrorInvalidValue;
  FwdArgs f{{c, cb_bf16}, {b, cb_bf16}, {l, l_bf16}, {x, x_bf16},
            di, dout, s0, y, s_final, states, chunks, q, n, p};
  return launch(ssd_fwd_kernel<true>, groups,
                smem_floats(true, q, n, p) * sizeof(float), stream, f);
}

extern "C" int ssd_chunk_diag(const void* c, const void* b, const void* l,
                              const void* x, void* y, int groups, int q,
                              int n, int p, int cb_bf16, int l_bf16,
                              int x_bf16, void* stream) {
  if (!geometry_ok(groups, 1, q, n, p)) return cudaErrorInvalidValue;
  FwdArgs f{{c, cb_bf16}, {b, cb_bf16}, {l, l_bf16}, {x, x_bf16},
            nullptr, nullptr, nullptr, y, nullptr, nullptr, 1, q, n, p};
  return launch(ssd_fwd_kernel<false>, groups,
                smem_floats(false, q, n, p) * sizeof(float), stream, f);
}
