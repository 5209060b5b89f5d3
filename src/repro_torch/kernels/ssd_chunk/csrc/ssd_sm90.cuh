// Hopper (sm_90a) tile routines of the SSD chunked scan, for one warpgroup
// of 128 threads (route A of ssd_scan.cu and ssd_scan_bwd.cu): 64-row
// windows staged into shared memory by the block's own vector loads (bf16
// as it is, fp32 split into two or three bf16 windows), wgmma with A read
// from registers, and the conversions from wgmma's accumulator layout to
// its A fragments and to staged windows.
//
// A block may hold several warpgroups: each routine works on its own
// warpgroup's threads (threadIdx.x % WG).
//
// Layouts (gemm_sm90.cuh's, as flash_bwd.cu uses them):
//   * a window is 64 rows x D columns of bf16, stored as D / 32 panels of
//     64 rows x 64 bytes (PANEL bytes each, on 512-byte boundaries: the
//     64-byte swizzle repeats every 8 rows), the 16-byte chunk index XORed
//     with bits 1-2 of the row;
//   * read K-major (its rows are M or N, its columns K), k-step kk is
//     desc_k64(window + (kk / 2) PANEL + (kk % 2) 32);
//   * read MN-major (its rows are K, its columns M or N), k-step kk of 16
//     rows is desc_mn64(window + kk 1024), whose leading offset steps from
//     one panel to the next;
//   * an fp32 operand is split into hi = bf16(x) and lo = bf16(x - hi)
//     (2^-16 relative left out), staged as its hi window (D * 128 bytes)
//     followed by its lo window; where that is not enough, into three
//     pieces, a third window of bf16(x - hi - lo) (2^-24 left out).  A
//     product with one fp32 operand runs once a piece, with two fp32
//     operands three times (hi hi, hi lo, lo hi), or six in three pieces
//     (the pairs whose piece indices sum to at most 2); bf16 operands go
//     in exactly, and every sum is fp32;
//   * wgmma's accumulator: register 4 j + 2 h + c of a thread holds row
//     r0 + 8 h, column 8 j + c0 + c, with r0 = 16 warp + lane / 4 and
//     c0 = 2 (lane % 4).  The register A fragment of k-step kk is the
//     accumulator's registers 8 kk + 2 m and 8 kk + 2 m + 1, m = 0..3, each
//     pair packed as two bf16.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "../../gemm/csrc/gemm_sm90.cuh"

namespace ssd_sm90 {

constexpr int WG = 128;      // threads of the warpgroup
constexpr int PANEL = 4096;  // 64 rows x 64 bytes

using Frag = uint32_t[4][4];  // register A fragments of a 64 x 64 tile

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (a, b) as a bf16 pair hi, and what hi leaves out in (a, b).
__device__ __forceinline__ uint32_t split_step(float& a, float& b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  a -= f.x;
  b -= f.y;
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (a, b) as a bf16 pair hi and the pair of their residuals lo.
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  hi = split_step(a, b);
  lo = pack_bf16(a, b);
}

// (a, b) as PIECES bf16 pairs, each of what the earlier ones leave out,
// into the PIECES windows at dst, `stride` bytes apart.
template <int PIECES>
__device__ __forceinline__ void store_pieces(unsigned char* dst, int stride,
                                             float a, float b) {
#pragma unroll
  for (int k = 0; k < PIECES; ++k)
    *reinterpret_cast<uint32_t*>(dst + k * stride) = split_step(a, b);
}

// The byte offset of (row r, even column c) in a window.
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 5) * PANEL + r * 64 +
         ((((c >> 3) & 3) ^ ((r >> 1) & 3)) << 4) + (c & 7) * 2;
}

__device__ __forceinline__ uint64_t kmaj(uint32_t window, int kk) {
  return sm90::desc_k64(window + (kk >> 1) * PANEL + (kk & 1) * 32);
}

__device__ __forceinline__ uint64_t mnmaj(uint32_t window, int kk) {
  return sm90::desc_mn64(window + kk * 1024);
}

// Rows [0, 64) x D of a bf16 matrix with row stride ld, for a window:
// four threads a 64-byte panel row, so a warp reads 128-byte runs and
// stores 512 contiguous bytes.  The loads (load) and the shared-memory
// stores (store) are apart, so that a block issues all the loads of a
// staging before any store: a store through a generic pointer could alias
// the next load, and interleaved they would wait out one load latency
// each.
template <int D>
struct Bf16Rows {
  uint4 v[D / 16];
  __device__ __forceinline__ void load(const __nv_bfloat16* src, int ld) {
#pragma unroll
    for (int k = 0; k < D / 16; ++k) {
      const int t = threadIdx.x % WG + k * WG;
      const int ch = t & 3, r = (t >> 2) & 63, panel = t >> 8;
      v[k] = __ldg(reinterpret_cast<const uint4*>(
          src + (int64_t)r * ld + panel * 32 + ch * 8));
    }
  }
  __device__ __forceinline__ void store(unsigned char* dst) const {
#pragma unroll
    for (int k = 0; k < D / 16; ++k) {
      const int t = threadIdx.x % WG + k * WG;
      const int ch = t & 3, r = (t >> 2) & 63, panel = t >> 8;
      *reinterpret_cast<uint4*>(dst + panel * PANEL + r * 64 +
                                ((ch ^ ((r >> 1) & 3)) << 4)) = v[k];
    }
  }
};

// Rows [0, 64) x D of an fp32 matrix with row stride ld, each row times
// scale[r] when scale is given (one fp32 product, as the reference forms
// dY * decay), for PIECES split windows (hi, lo, ...): eight threads a
// 128-byte row run.
template <int D>
struct F32Rows {
  float4 v[D / 8];
  __device__ __forceinline__ void load(const float* src, int ld,
                                       const float* scale) {
#pragma unroll
    for (int k = 0; k < D / 8; ++k) {
      const int t = threadIdx.x % WG + k * WG;
      const int qd = t & 7, r = (t >> 3) & 63, panel = t >> 9;
      v[k] = __ldg(reinterpret_cast<const float4*>(
          src + (int64_t)r * ld + panel * 32 + qd * 4));
      if (scale != nullptr) {
        const float s = scale[r];
        v[k].x *= s;
        v[k].y *= s;
        v[k].z *= s;
        v[k].w *= s;
      }
    }
  }
  template <int PIECES>
  __device__ __forceinline__ void store(unsigned char* dst) const {
#pragma unroll
    for (int k = 0; k < D / 8; ++k) {
      const int t = threadIdx.x % WG + k * WG;
      const int qd = t & 7, r = (t >> 3) & 63, panel = t >> 9;
      const int off = panel * PANEL + r * 64 +
                      (((qd >> 1) ^ ((r >> 1) & 3)) << 4) + (qd & 1) * 8;
      float4 x = v[k];
#pragma unroll
      for (int pc = 0; pc < PIECES; ++pc) {
        const uint32_t lo = split_step(x.x, x.y);
        *reinterpret_cast<uint2*>(dst + pc * D * 128 + off) =
            make_uint2(lo, split_step(x.z, x.w));
      }
    }
  }
};

// A thread's part of a 64 x 2N fp32 accumulator (N registers), split
// into the PIECES windows at dst.
template <int N, int PIECES>
__device__ __forceinline__ void store_split(unsigned char* dst,
                                            const float* x) {
  const int r0 = 16 * (threadIdx.x % WG / 32) + (threadIdx.x % 32) / 4;
  const int c0 = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      store_pieces<PIECES>(dst + swz(r0 + 8 * h, 8 * j + c0), N * 256,
                           x[4 * j + 2 * h], x[4 * j + 2 * h + 1]);
}

// The A fragments (hi and lo) of a thread's part of a 64 x 64 fp32 tile
// in the accumulator layout.
__device__ __forceinline__ void frag_split(const float* x, Frag& hi,
                                           Frag& lo) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int e = 8 * kk + 2 * m;
      split2(x[e], x[e + 1], hi[kk][m], lo[kk][m]);
    }
}

// The same in three pieces (hi, lo, lo2), each of what the earlier ones
// leave out.
__device__ __forceinline__ void frag_split3(const float* x, Frag& hi,
                                            Frag& lo, Frag& lo2) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int e = 8 * kk + 2 * m;
      float a = x[e], b = x[e + 1];
      hi[kk][m] = split_step(a, b);
      lo[kk][m] = split_step(a, b);
      lo2[kk][m] = pack_bf16(a, b);
    }
}

// Keeps the compiler from reusing fragment registers that an asynchronous
// wgmma may still read (place after the wait).
__device__ __forceinline__ void fence_frag(Frag& a) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int m = 0; m < 4; ++m) asm volatile("" : "+r"(a[kk][m])::"memory");
}

// Four floats of another block's shared memory, at a distributed
// shared-memory address (16-byte aligned).
__device__ __forceinline__ float4 ld_dsmem4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// Asks L2 for the 128-byte line holding p, for a later load.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// D(64 x N) += A(64 x 16, registers) * B(16 x N, shared memory), bf16
// operands, fp32 sums.  TB = 1: B is MN-major.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}

// Both operands in shared memory, as gemm_sm90.cuh's products.
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db) {
  if constexpr (N == 128)
    sm90::wgmma_n128<TA, TB>(d, da, db);
  else
    sm90::wgmma_n64<TA, TB>(d, da, db);
}

template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (N == 128)
    wgmma_rs_n128<TB>(d, a, db);
  else
    wgmma_rs_n64<TB>(d, a, db);
}

// d (64 x N) += A Bᵀ over K = 16 KS columns, both windows K-major.
template <int N, int KS>
__device__ __forceinline__ void mma_kk(float* d, uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) wgmma_ss<N, 0, 0>(d, kmaj(a, kk), kmaj(b, kk));
}

// d (64 x N) += A B over K = 64 rows: A's window K-major, B's MN-major.
template <int N>
__device__ __forceinline__ void mma_km(float* d, uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss<N, 0, 1>(d, kmaj(a, kk), mnmaj(b, kk));
}

// d (64 x N) += A B over K = 64 rows, A from register fragments, B's
// window MN-major.
template <int N>
__device__ __forceinline__ void mma_rm(float* d, const Frag& a,
                                       uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<N, 1>(d, a[kk], mnmaj(b, kk));
}

}  // namespace ssd_sm90
