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
// fp32 dK/dV accumulators in shared memory for the whole walk, and stores
// only the rows [k0, k_end) it owns -- no two blocks own a dK/dV row, so
// those stores need no atomics.  A k-block no query reaches (causal, sk > sq)
// stores zeros.  D is recomputed per tile from the dO and O windows (the
// block loads dO anyway), in place of the reference's first-tile scratch.
// dQ rows are shared between k-blocks: each block atomicAdds its dS K into
// the owned rows of a caller-zeroed fp32 (BH, sq, d) buffer, so dQ's sum
// order changes from run to run (fp32 rounding differences only).
//
// What bounds it on the H100 at the training shape (BH = 128 = batch 8 x 16
// heads, sq = sk = 128, d = 128, causal, bf16): 0.34 GFLOP of useful work
// against 42 MB of operands and gradients (dK/dV in fp32), ~8 flop/byte,
// below the ~295 flop/byte ridge: bytes bound it (12.5 us at 3.35 TB/s).
// The simple design: every tile product in fp32 on CUDA cores from shared
// memory (q, k, v and dO windows upcast on load, rows padded against bank
// conflicts), 256 threads, one block per SM (210 KB at 64 x 64 x 128).
// Tensor-core products, TMA pipelining and a deterministic dQ are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int BQ_MAX = 64;
constexpr int BK_MAX = 64;
constexpr int D_MAX = 128;
constexpr int PAD = 1;  // floats of padding per staged row

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

template <typename T>
cudaError_t launch(const BwdArgs& f, dim3 grid, cudaStream_t s) {
  const size_t smem = smem_bytes(f.bq, f.bk, f.d);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  flash_bwd_kernel<T><<<grid, NT, smem, s>>>(f);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_bwd_fused(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const float* lse, float* dq, float* dk,
                               float* dv, const int* table, const int* koff,
                               const int* krows, int num_k_blocks, int bh,
                               int sq, int sk, int d, int bq, int bk,
                               int causal, float scale, int dtype,
                               void* stream) {
  BwdArgs f{q,  k,    v,     o,  dout, lse, dq, dk,     dv,   table,
            koff, krows, sq, sk, d,    bq,  bk, causal, scale};
  if (bq < 1 || bq > BQ_MAX || bk < 1 || bk > BK_MAX || d < 1 || d > D_MAX ||
      bq > sq || bk > sk)
    return cudaErrorInvalidValue;
  dim3 grid(num_k_blocks, bh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<__nv_bfloat16>(f, grid, s);
  if (dtype == 0) return launch<float>(f, grid, s);
  return cudaErrorInvalidValue;
}
