// Backward of the Mamba-2 SSD chunked scan for Hopper (sm_90a): one launch
// walks every group's chunks last to first with the (p, n) state cotangent
// carried, and writes all seven cotangents (ssd_scan_bwd).
//
// Replaces the reference package's TPU kernel
// src/repro/kernels/ssd_chunk/kernel.py::build_ssd_scan_bwd_kernel
// (_ssd_scan_bwd_body).  There a (groups, chunks) grid with the chunk
// coordinate flipped walks chunks in reverse, dS in VMEM scratch, each
// step recomputing a whole chunk's (Q, Q) scores in VMEM.  Here one thread
// block owns a group and loops over its chunks in reverse with dS in
// shared memory; per chunk it reads the state the forward saved on entry
// (S_in) and, in fp32 throughout, takes three passes:
//
//   rows:    per block of RB rows and slice of RB columns, scores = C·Bᵀ
//            and dW = dY·xdtᵀ are recomputed; dL = dW ⊙ scores is written
//            once per element; dC = (dW ⊙ L)·B + (dY ⊙ di)·S_in;
//            d_decay_in = Σ_p dY ⊙ (C·S_inᵀ), plus Σ S_in ⊙ dS at Q-1;
//   columns: per block of RB columns, dB and dxdt gather every row's
//            contribution, (dW ⊙ L)ᵀ·C and (scores ⊙ L)ᵀ·dY over row
//            slices, on top of the state leg (xdt ⊙ do)·dS and
//            (B·dSᵀ) ⊙ do; d_decay_out = Σ_p (B·dSᵀ) ⊙ xdt.  A block owns
//            its columns' accumulators in shared memory, so they sum in a
//            fixed order without atomics (deterministic);
//   state:   dS ← dS · di[Q-1] + (dY ⊙ di)ᵀ·C.
//
// ds0 takes dS after the first chunk.  Each pass recomputes what it needs
// instead of staging the (Q, Q) tiles or the (Q, n) and (Q, p) fp32
// accumulators of a whole chunk, which do not fit beside the two (p, n)
// states.  Numerics follow the reference kernel: every operand widened
// to fp32, no rounding point (dY and dS_final arrive as fp32), every
// cotangent fp32.
//
// What bounds it on the H100 at the training shape (192 groups x 4
// chunks, Q 256, n 128, p 64): ~68 GFLOP of fp32 products (~1 ms at
// 67 TFLOP/s) against ~0.9 GB (~0.27 ms; dL alone is 201 MB), so
// operations.  The design takes the simple route: fp32 CUDA-core products
// from shared memory, the scores and dW recomputed in both the row and
// the column pass (7 products of a chunk's (Q, Q) size against the 5 the
// math needs), one block per group.  Tensor-core products and splitting a
// group's chunks over blocks are later work.

#include "ssd_common.cuh"

namespace {

using namespace ssd;

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

__global__ void __launch_bounds__(NT) ssd_bwd_kernel(BwdArgs f) {
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

}  // namespace

extern "C" int ssd_scan_bwd(const void* c, const void* b, const void* l,
                            const void* x, const float* di, const float* dout,
                            const float* states, const float* dy,
                            const float* dsf, float* dc, float* db, float* dl,
                            float* dx, float* ddi, float* ddo, float* ds0,
                            int groups, int chunks, int q, int n, int p,
                            int cb_bf16, int l_bf16, int x_bf16,
                            void* stream) {
  if (!geometry_ok(groups, chunks, q, n, p)) return cudaErrorInvalidValue;
  BwdArgs f{{c, cb_bf16}, {b, cb_bf16}, {l, l_bf16}, {x, x_bf16},
            di, dout, states, dy, dsf, dc, db, dl, dx, ddi, ddo, ds0,
            chunks, q, n, p};
  return launch(ssd_bwd_kernel, groups, smem_floats(q, n, p) * sizeof(float),
                stream, f);
}
