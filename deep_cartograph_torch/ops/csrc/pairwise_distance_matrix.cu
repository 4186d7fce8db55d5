// K3: all-pairs distance matrix per frame, CUDA C++ for Hopper.
//
// Replaces the TPU kernel ops/pallas_kernels.py::pairwise_distance_matrix
// (body _pairdist_kernel) of the JAX package. Like that kernel it sums
// exact per-channel differences, sqrt(sum_c (a_c - b_c)^2), not the Gram
// form |a|^2 + |b|^2 - 2 a.b, which loses digits to cancellation.
//
//   out[f, i, j] = sqrt((x_i - x_j)^2 + (y_i - y_j)^2 + (z_i - z_j)^2)
//   coords (F, A, 3) f32, out (F, A, A) f32, same units as coords.
//
// Bound on the H100: bytes. Each output element costs 4 bytes against ~9
// flops, so writing F*A*A*4 bytes is the limit; the coordinates (F*A*12
// bytes) are read about A/kRows times over, all from L2.
//
// Design: a block owns one frame and a tile of kRows rows x kCols columns.
// Each thread owns one column: it keeps that atom's coordinates in
// registers and writes its column of the tile row by row, so a warp's 32
// stores are consecutive (coalesced 128-byte lines). The tile's row atoms
// are staged in shared memory, one array per axis, and read as broadcasts.
// The ragged edge is masked in the kernel (columns >= A write nothing, the
// last row tile is short); the host pads nothing. Frames beyond the grid's
// z limit are covered by a stride loop.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 128;  // threads per block, one column each
constexpr int kRows = 32;   // rows per tile
constexpr int kMaxGridZ = 65535;

__global__ void __launch_bounds__(kCols)
pairwise_distance_matrix_kernel(const float* __restrict__ coords,
                                float* __restrict__ out, int F, int A) {
  __shared__ float rx[kRows], ry[kRows], rz[kRows];
  const int j = blockIdx.x * kCols + threadIdx.x;
  const int i0 = blockIdx.y * kRows;
  const int rows = min(kRows, A - i0);

  for (int f = blockIdx.z; f < F; f += gridDim.z) {
    const float* c = coords + (size_t)f * A * 3;
    __syncthreads();  // the previous frame's rows are consumed
    if (threadIdx.x < rows) {
      const float* r = c + (size_t)(i0 + threadIdx.x) * 3;
      rx[threadIdx.x] = r[0];
      ry[threadIdx.x] = r[1];
      rz[threadIdx.x] = r[2];
    }
    __syncthreads();
    if (j >= A) continue;
    const float bx = c[(size_t)j * 3];
    const float by = c[(size_t)j * 3 + 1];
    const float bz = c[(size_t)j * 3 + 2];
    float* dst = out + ((size_t)f * A + i0) * A + j;
    for (int r = 0; r < rows; ++r) {
      const float dx = rx[r] - bx;
      const float dy = ry[r] - by;
      const float dz = rz[r] - bz;
      dst[(size_t)r * A] = sqrtf(dx * dx + dy * dy + dz * dz);
    }
  }
}

}  // namespace

extern "C" {

const char* dc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch on `stream`; returns cudaGetLastError(). The caller checks shapes,
// dtype and contiguity.
int pairwise_distance_matrix(const float* coords, float* out, int F, int A,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (F == 0 || A == 0) return cudaSuccess;
  const dim3 grid((A + kCols - 1) / kCols, (A + kRows - 1) / kRows,
                  F < kMaxGridZ ? F : kMaxGridZ);
  pairwise_distance_matrix_kernel<<<grid, kCols, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      coords, out, F, A);
  return cudaGetLastError();
}

}  // extern "C"
