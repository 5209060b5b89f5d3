// Blocked (batched) transpose for Hopper (sm_90a):
//   out[b, c, r] = x[b, r, c],  (nb, rows, cols) -> (nb, cols, rows).
//
// Replaces the reference package's TPU kernel
// src/repro/kernels/transpose/kernel.py::build_transpose_kernel
// (_transpose_body): there a (nb, ceil(rows/bt), ceil(cols/bt)) grid stages
// each (bt, bt) block through a VMEM scratch tile and writes its transpose
// at the mirrored block (b, j, i), relying on clipped stores at the edges.
// Here one thread block of 32 x 8 threads per (bt x bt) tile, the batch as
// the grid's z dimension: the tile is read row by row (neighbouring
// threads on neighbouring columns: coalesced), staged in shared memory
// padded by one element per row, and written row by row of the output
// (neighbouring threads on neighbouring source rows: coalesced), so the
// column reads of the staged tile fall in distinct banks.  Edge tiles
// predicate both the load and the store: nothing outside the logical
// (rows, cols) extent is read, so a padded source view may hold NaN past
// its edge.  The source may be such a view: its row and batch strides are
// arguments (unit column stride).  The copy moves bits, one template per
// element size, so it is bit-exact for every dtype.
//
// What bounds it on the H100: pure data movement, rows x cols elements
// read once and written once at 3.35 TB/s (Qwen3-0.6B's tied table,
// 151,936 x 1,024 bf16, is 311 MB each way: 0.186 ms).  The simple
// design does one tile per block with no vectorised (16-byte) loads and
// no TMA; those are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 32, TY = 8;  // threads per block: 32 x 8
// The tile edges this kernel instantiates (H100_SXM.transpose_tiles).
constexpr int BT_SMALL = 32;
constexpr int BT_LARGE = 64;

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
cudaError_t launch(const void* x, void* out, int nb, int rows, int cols,
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

}  // namespace

extern "C" int transpose(const void* x, void* out, int nb, int rows, int cols,
                         long long row_stride, long long batch_stride, int bt,
                         int elem_bytes, void* stream) {
  if ((bt != BT_SMALL && bt != BT_LARGE) || nb < 1 || nb > 65535 ||
      rows < 1 || cols < 1 || (rows + bt - 1) / bt > 65535 ||
      row_stride < cols)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1: return launch<uint8_t>(x, out, nb, rows, cols, row_stride,
                                   batch_stride, bt, s);
    case 2: return launch<uint16_t>(x, out, nb, rows, cols, row_stride,
                                    batch_stride, bt, s);
    case 4: return launch<uint32_t>(x, out, nb, rows, cols, row_stride,
                                    batch_stride, bt, s);
    case 8: return launch<uint64_t>(x, out, nb, rows, cols, row_stride,
                                    batch_stride, bt, s);
    default: return cudaErrorInvalidValue;
  }
}
