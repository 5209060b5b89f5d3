// Blocked (batched) transpose for Hopper (sm_90a):
//   out[b, c, r] = x[b, r, c],  (nb, rows, cols) -> (nb, cols, rows).
//
// Replaces the reference package's TPU kernel
// src/repro/kernels/transpose/kernel.py:31 (build_transpose_kernel,
// _transpose_body): there a (nb, ceil(rows/bt), ceil(cols/bt)) grid stages
// each (bt, bt) block through a VMEM scratch tile and writes its transpose
// at the mirrored block (b, j, i), relying on clipped stores at the edges.
// The copy moves bits, one instantiation per element size (1, 2, 4 or 8
// bytes), so it is bit-exact for every dtype.  The source may be a view
// whose row and batch strides exceed its extent (unit column stride);
// nothing outside the logical (rows, cols) extent is read, so a padded
// view may hold NaN past its edge.
//
// What bounds it on the H100: pure data movement, rows x cols elements
// read once and written once at 3.35 TB/s (Qwen3-0.6B's tied table,
// 151,936 x 1,024 bf16, is 311 MB each way: 0.186 ms).  It does no
// arithmetic; the design keeps enough bytes in flight and makes both the
// reads and the writes whole 128-byte lines.
//
// Two routes (transpose/kernel.py::choose_route picks one; route_a_ok
// below is its mirror):
//
// (A) views TMA can address: a 16-byte aligned base, row and batch strides
//     and an output row (rows x elem bytes) that are multiples of 16 bytes.
//     A persistent grid (the SM count times the blocks an SM holds) walks
//     the (b, i, j) tiles of bt x bt elements, each tile owned by one
//     block (tile t, t + grid, ...; a_tile gives the order: row tile by
//     row tile, the column tiles fastest, so that the tiles in flight read
//     whole source rows -- on the H100 5-17% ahead of walks that write
//     longer pieces of each output row, PERF.md).  Thread 0 keeps a
//     ring of A_STAGES tiles in flight: TMA loads of a 3-D map over the
//     source's logical extent with its real strides, boxes up to 128 bytes
//     wide in the matching swizzle (past the extent TMA fills zeros and
//     reads nothing), each stage completing on its mbarrier.  The block's
//     four warps transpose a staged tile into one of two output tiles in
//     shared memory: a thread reads an element size down a column (the 32
//     lanes of a warp on neighbouring columns of one row: no bank
//     conflict) and writes the 16 bytes it packed as one chunk of an
//     output row (the swizzle puts the chunks of eight neighbouring rows in
//     distinct banks).  Thread 0 then stores the output tile whole with
//     cp.async.bulk.tensor through a map over the output, which clips the
//     edges (7% ahead of 16-byte st.global of whole 128-byte segments,
//     PERF.md); the output tile is written again two tiles later,
//     after bulk_wait_read.
// (B) everything else (a base, stride or output row off 16 bytes): one
//     thread block of 32 x 8 threads per (bt x bt) tile, the batch as the
//     grid's z dimension, element-wide loads and stores through a shared
//     tile padded by one element a row (conflict-free column reads), both
//     edges predicated.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../gemm/csrc/gemm_sm90.cuh"
#include "../../gemm/csrc/wgmma_tile.cuh"  // wgt::encode_tiled

namespace {

// The tile edges this kernel instantiates (H100_SXM.transpose_tiles).
constexpr int BT_SMALL = 32;
constexpr int BT_LARGE = 64;

enum { ROUTE_A = 0, ROUTE_B = 1 };

// ---- route B ----------------------------------------------------------------

constexpr int TX = 32, TY = 8;  // threads per block: 32 x 8

template <typename T, int BT>
__global__ void __launch_bounds__(TX * TY)
transpose_kernel(const T* __restrict__ x, T* __restrict__ out, int rows,
                 int cols, int64_t x_row_stride, int64_t x_batch_stride) {
  __shared__ T tile[BT][BT + 1];
  const int r0 = blockIdx.y * BT, c0 = blockIdx.x * BT;
  const T* xb = x + (int64_t)blockIdx.z * x_batch_stride;
  T* ob = out + (int64_t)blockIdx.z * rows * cols;
  for (int i = threadIdx.y; i < BT; i += TY)
    for (int j = threadIdx.x; j < BT; j += TX) {
      const int r = r0 + i, c = c0 + j;
      if (r < rows && c < cols) tile[i][j] = xb[(int64_t)r * x_row_stride + c];
    }
  __syncthreads();
  for (int i = threadIdx.y; i < BT; i += TY)
    for (int j = threadIdx.x; j < BT; j += TX) {
      const int c = c0 + i, r = r0 + j;  // out row c, out column r
      if (c < cols && r < rows) ob[(int64_t)c * rows + r] = tile[j][i];
    }
}

template <typename T>
cudaError_t launch_b(const void* x, void* out, int nb, int rows, int cols,
                     int64_t row_stride, int64_t batch_stride, int bt,
                     cudaStream_t s) {
  dim3 block(TX, TY);
  dim3 grid((cols + bt - 1) / bt, (rows + bt - 1) / bt, nb);
  const T* xs = static_cast<const T*>(x);
  T* os = static_cast<T*>(out);
  if (bt == BT_SMALL)
    transpose_kernel<T, BT_SMALL><<<grid, block, 0, s>>>(
        xs, os, rows, cols, row_stride, batch_stride);
  else
    transpose_kernel<T, BT_LARGE><<<grid, block, 0, s>>>(
        xs, os, rows, cols, row_stride, batch_stride);
  return cudaGetLastError();
}

// ---- route A ----------------------------------------------------------------

constexpr int A_THREADS = 128;  // four warps: the transpose; thread 0 also
                                // issues the loads and the stores
constexpr int A_STAGES = 4;     // tiles in flight a block
constexpr int OUT_TILES = 2;    // output tiles in shared memory
constexpr int BOX_BYTES = 128;  // the widest box row: the 128-byte swizzle

// A box row: bt elements, at most BOX_BYTES (32, 64 or 128 bytes).
__host__ __device__ constexpr int box_row(int elem, int bt) {
  return elem * bt < BOX_BYTES ? elem * bt : BOX_BYTES;
}
__host__ __device__ constexpr int tile_bytes(int elem, int bt) {
  return elem * bt * bt;
}
// 1024 bytes of alignment slack (the 128-byte swizzle repeats every 1024),
// the ring, the output tiles and an mbarrier a stage.
__host__ __device__ constexpr int a_smem(int elem, int bt) {
  return 1024 + (A_STAGES + OUT_TILES) * tile_bytes(elem, bt) + A_STAGES * 8;
}
static_assert(a_smem(8, BT_LARGE) <= 232448, "the ring fits a block");

// The swizzle TMA applies to a box of `rb`-byte rows: the 16-byte chunk
// index XORed with the bits of the 128-byte line above it (one bit for
// 32-byte rows, two for 64, three for 128).
template <int RB>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  return off ^ (((off >> 7) & (RB / 16 - 1)) << 4);
}

struct ArgsA {
  int ti, tj;         // row and column tiles a batch
  int64_t tiles;      // nb * ti * tj
};

// Tile t of the walk: batch by batch, row tile by row tile, the column
// tile fastest.
__device__ __forceinline__ void a_tile(int64_t t, const ArgsA& f, int& b,
                                       int& i, int& j) {
  const int64_t per_batch = (int64_t)f.ti * f.tj;
  b = (int)(t / per_batch);
  const int64_t u = t - b * per_batch;
  i = (int)(u / f.tj);
  j = (int)(u % f.tj);
}

// Element k of a 16-byte chunk, read from shared memory at p.
template <int E>
__device__ __forceinline__ void put(uint32_t (&w)[4], int k,
                                    const uint8_t* p) {
  if constexpr (E == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[2 * k] = v.x;
    w[2 * k + 1] = v.y;
  } else if constexpr (E == 4) {
    w[k] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (E == 2) {
    w[k / 2] |= (uint32_t)*reinterpret_cast<const uint16_t*>(p)
                << (16 * (k % 2));
  } else {
    w[k / 4] |= (uint32_t)*p << (8 * (k % 4));
  }
}

template <int E, int BT>
__global__ void __launch_bounds__(A_THREADS)
transpose_tma(const __grid_constant__ CUtensorMap src,
              const __grid_constant__ CUtensorMap dst,
              const __grid_constant__ ArgsA f) {
  constexpr int RB = box_row(E, BT);      // box row bytes
  constexpr int BOXC = RB / E;            // box columns
  constexpr int BOX = BT * RB;            // box bytes
  constexpr int NBOX = BT * E / RB;       // boxes a tile, side by side
  constexpr int TILE = tile_bytes(E, BT);
  constexpr int V = 16 / E;               // elements a 16-byte chunk
  constexpr int CHUNKS = BT * BT / V;     // chunks a tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t ring = base, outs = base + A_STAGES * TILE;
  const uint32_t bars = outs + OUT_TILES * TILE;
  const int tid = threadIdx.x;
  const int64_t grid = gridDim.x;
  const int mine = (int)((f.tiles - blockIdx.x + grid - 1) / grid);

  auto load = [&](int it) {
    int b, i, j;
    a_tile(blockIdx.x + it * grid, f, b, i, j);
    const int s = it % A_STAGES;
    const uint32_t bar = bars + 8 * s;
    sm90::mbar_expect_tx(bar, TILE);
#pragma unroll
    for (int n = 0; n < NBOX; ++n)
      sm90::tma_load_3d(ring + s * TILE + n * BOX, &src, bar,
                        j * BT + n * BOXC, i * BT, b);
  };

  if (tid == 0) {
    sm90::prefetch_map(&src);
    sm90::prefetch_map(&dst);
    for (int s = 0; s < A_STAGES; ++s) sm90::mbar_init(bars + 8 * s, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int it = 0; it < A_STAGES && it < mine; ++it) load(it);

  for (int it = 0; it < mine; ++it) {
    int b, i, j;
    a_tile(blockIdx.x + it * grid, f, b, i, j);
    const int s = it % A_STAGES;
    const uint32_t ob = outs + (it % OUT_TILES) * TILE;
    const uint8_t* const stage = gbase + (ring - base) + s * TILE;
    uint8_t* const otile = gbase + (ob - base);
    sm90::mbar_wait(bars + 8 * s, (it / A_STAGES) & 1);
    // Output row c (source column c), chunk q (source rows qV .. qV+V-1).
    for (int u = tid; u < CHUNKS; u += A_THREADS) {
      const int c = u % BT, q = u / BT;
      const uint8_t* const col = stage + (c / BOXC) * BOX;
      const uint32_t cbyte = (c % BOXC) * E;
      uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int k = 0; k < V; ++k)
        put<E>(w, k, col + swz<RB>((q * V + k) * RB + cbyte));
      const uint32_t doff = c * RB + ((q * V) % BOXC) * E;
      *reinterpret_cast<uint4*>(otile + ((q * V) / BOXC) * BOX +
                                swz<RB>(doff)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
    sm90::fence_proxy_async();
    // The previous tile's stores have read the other output tile, which
    // the next iteration writes.
    if (tid == 0) sm90::bulk_wait_read<0>();
    __syncthreads();
    if (tid == 0) {
#pragma unroll
      for (int m = 0; m < NBOX; ++m)
        sm90::tma_store_3d(&dst, ob + m * BOX, i * BT + m * BOXC, j * BT, b);
      sm90::bulk_commit();
      if (it + A_STAGES < mine) load(it + A_STAGES);
    }
  }
  if (tid == 0) sm90::bulk_wait<0>();
}

CUtensorMapDataType elem_type(int elem) {
  switch (elem) {
    case 1: return CU_TENSOR_MAP_DATA_TYPE_UINT8;
    case 2: return CU_TENSOR_MAP_DATA_TYPE_UINT16;
    case 4: return CU_TENSOR_MAP_DATA_TYPE_UINT32;
    default: return CU_TENSOR_MAP_DATA_TYPE_UINT64;
  }
}

// A 3-D map over (inner, outer, batch) elements with the given byte strides
// and a (box_inner, bt, 1) box in the swizzle of its row bytes.
bool encode(CUtensorMap* map, const void* ptr, int elem, uint64_t inner,
            uint64_t outer, uint64_t batch, uint64_t outer_bytes,
            uint64_t batch_bytes, int bt) {
  const wgt::EncodeTiled fn = wgt::encode_tiled();
  if (!fn) return false;
  const int rb = box_row(elem, bt);
  const CUtensorMapSwizzle sw = rb == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : rb == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                           : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint64_t dims[3] = {inner, outer, batch};
  const cuuint64_t strides[2] = {outer_bytes, batch_bytes};
  const cuuint32_t box[3] = {(cuuint32_t)(rb / elem), (cuuint32_t)bt, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  return fn(map, elem_type(elem), 3, const_cast<void*>(ptr), dims, strides,
            box, one, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int E, int BT>
cudaError_t launch_a(const void* x, void* out, int nb, int rows, int cols,
                     int64_t row_stride, int64_t batch_stride,
                     cudaStream_t stream) {
  const auto kernel = transpose_tma<E, BT>;
  constexpr int smem = a_smem(E, BT);
  // Asked once, so that a launch inside a CUDA-graph capture makes no
  // attribute or occupancy call.
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  static int per_sm = 0, sms = 0;
  if (!per_sm) {
    int dev;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        A_THREADS, smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
  }
  CUtensorMap src, dst;
  if (!encode(&src, x, E, cols, rows, nb, row_stride * E, batch_stride * E,
              BT) ||
      !encode(&dst, out, E, rows, cols, nb, (uint64_t)rows * E,
              (uint64_t)rows * cols * E, BT))
    return cudaErrorInvalidValue;
  ArgsA f;
  f.ti = (rows + BT - 1) / BT;
  f.tj = (cols + BT - 1) / BT;
  f.tiles = (int64_t)nb * f.ti * f.tj;
  const int64_t most = (int64_t)sms * per_sm;
  const int blocks = (int)(f.tiles < most ? f.tiles : most);
  kernel<<<blocks, A_THREADS, smem, stream>>>(src, dst, f);
  return cudaGetLastError();
}

template <int E>
cudaError_t dispatch_a(const void* x, void* out, int nb, int rows, int cols,
                       int64_t rs, int64_t bs, int bt, cudaStream_t s) {
  return bt == BT_SMALL
             ? launch_a<E, BT_SMALL>(x, out, nb, rows, cols, rs, bs, s)
             : launch_a<E, BT_LARGE>(x, out, nb, rows, cols, rs, bs, s);
}

// Route A's limits (kernel.py::choose_route mirrors them): an element of
// 1, 2, 4 or 8 bytes, a 16-byte aligned base, row and batch strides and an
// output row of whole 16-byte units (TMA's global strides, the output
// map's among them), strides under TMA's 2^40 bytes.
bool route_a_ok(const void* x, int rows, int cols, long long row_stride,
                long long batch_stride, int elem) {
  const long long lim = 1LL << 40;
  return (elem == 1 || elem == 2 || elem == 4 || elem == 8) &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         row_stride * elem % 16 == 0 && batch_stride * elem % 16 == 0 &&
         (long long)rows * elem % 16 == 0 && row_stride * elem < lim &&
         batch_stride * elem < lim && (long long)rows * cols * elem < lim;
}

}  // namespace

// route: ROUTE_A or ROUTE_B (kernel.py::choose_route).  Strides in
// elements.
extern "C" int transpose(const void* x, void* out, int nb, int rows, int cols,
                         long long row_stride, long long batch_stride, int bt,
                         int elem_bytes, int route, void* stream) {
  if ((bt != BT_SMALL && bt != BT_LARGE) || nb < 1 || rows < 1 || cols < 1 ||
      row_stride < cols)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == ROUTE_A) {
    if (!route_a_ok(x, rows, cols, row_stride, batch_stride, elem_bytes))
      return cudaErrorInvalidValue;
    switch (elem_bytes) {
      case 1: return dispatch_a<1>(x, out, nb, rows, cols, row_stride,
                                   batch_stride, bt, s);
      case 2: return dispatch_a<2>(x, out, nb, rows, cols, row_stride,
                                   batch_stride, bt, s);
      case 4: return dispatch_a<4>(x, out, nb, rows, cols, row_stride,
                                   batch_stride, bt, s);
      default: return dispatch_a<8>(x, out, nb, rows, cols, row_stride,
                                    batch_stride, bt, s);
    }
  }
  if (route != ROUTE_B || nb > 65535 || (rows + bt - 1) / bt > 65535)
    return cudaErrorInvalidValue;
  switch (elem_bytes) {
    case 1: return launch_b<uint8_t>(x, out, nb, rows, cols, row_stride,
                                     batch_stride, bt, s);
    case 2: return launch_b<uint16_t>(x, out, nb, rows, cols, row_stride,
                                      batch_stride, bt, s);
    case 4: return launch_b<uint32_t>(x, out, nb, rows, cols, row_stride,
                                      batch_stride, bt, s);
    case 8: return launch_b<uint64_t>(x, out, nb, rows, cols, row_stride,
                                      batch_stride, bt, s);
    default: return cudaErrorInvalidValue;
  }
}
