// K2: streaming KDE logsumexp for free-energy surfaces, CUDA C++ for Hopper.
//
// Replaces the TPU kernel ops/pallas_kernels.py::kde_logsumexp (body
// _kde_kernel) of the JAX package, which the FES code (fes/kde.py) switches
// to once grid x samples > 5e7.
//
//   out[g] = log sum_j exp(-|grid[g] - samples[j]|^2)
//   grid (G, D) f32, samples (N, D) f32, D <= 8, both pre-scaled by
//   sqrt(inv_two_bw2) by the caller; out (G,) f32.
//
// Bound on the H100: operations, the exponential. Every (grid point,
// sample) term needs one exp, which runs on the special-function units
// (16 per clock per SM), while the bytes (inputs and output, read once) are
// a few hundred kilobytes. The (G, N) matrix is never written.
//
// Design: one thread per grid point, its coordinates in registers, an online
// (max, sum) accumulator with one exp per term: for a new term v,
// e = exp(-|m - v|) rescales either the sum (v > m) or the term. Samples
// stream through shared memory in tiles that the block loads with coalesced
// reads. A grid of only G threads would leave most SMs idle (G = 22,500 is
// 176 blocks of 128), so the sample range is split over gridDim.y blocks;
// each writes a partial (max, sum) and a second kernel merges the splits and
// applies m + log(max(s, 1e-38)), as the TPU kernel does. Samples past N are
// never visited, so the ragged end needs no sentinel rows and contributes
// exactly 0.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 512;  // samples per shared-memory tile

template <int D>
__global__ void __launch_bounds__(kThreads)
kde_partial_kernel(const float* __restrict__ grid,
                   const float* __restrict__ samples,
                   float* __restrict__ part_m, float* __restrict__ part_s,
                   int G, int N, int per_split) {
  __shared__ float tile[kTile * D];
  const int g = blockIdx.x * kThreads + threadIdx.x;
  const int n0 = blockIdx.y * per_split;
  const int n1 = min(N, n0 + per_split);

  float q[D];
#pragma unroll
  for (int k = 0; k < D; ++k) q[k] = g < G ? grid[(size_t)g * D + k] : 0.f;

  float m = -INFINITY;
  float s = 0.f;
  for (int t0 = n0; t0 < n1; t0 += kTile) {
    const int nt = min(kTile, n1 - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < nt * D; i += kThreads)
      tile[i] = samples[(size_t)t0 * D + i];
    __syncthreads();
    for (int j = 0; j < nt; ++j) {
      float d2 = 0.f;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float d = q[k] - tile[j * D + k];
        d2 = fmaf(d, d, d2);
      }
      const float v = -d2;
      const float e = __expf(-fabsf(m - v));  // 0 while m is -inf
      s = v > m ? fmaf(s, e, 1.f) : s + e;
      m = fmaxf(m, v);
    }
  }
  if (g < G) {
    part_m[(size_t)blockIdx.y * G + g] = m;
    part_s[(size_t)blockIdx.y * G + g] = s;
  }
}

__global__ void kde_combine_kernel(const float* __restrict__ part_m,
                                   const float* __restrict__ part_s,
                                   float* __restrict__ out, int G,
                                   int splits) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  float m = -INFINITY;
  for (int y = 0; y < splits; ++y) m = fmaxf(m, part_m[(size_t)y * G + g]);
  float s = 0.f;
  for (int y = 0; y < splits; ++y) {
    const float sy = part_s[(size_t)y * G + g];
    if (sy > 0.f) s = fmaf(sy, expf(part_m[(size_t)y * G + g] - m), s);
  }
  out[g] = m + logf(fmaxf(s, 1e-38f));
}

template <int D>
void launch_partial(dim3 blocks, cudaStream_t stream, const float* grid,
                    const float* samples, float* part_m, float* part_s, int G,
                    int N, int per_split) {
  kde_partial_kernel<D><<<blocks, kThreads, 0, stream>>>(
      grid, samples, part_m, part_s, G, N, per_split);
}

}  // namespace

extern "C" {

const char* dc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Number of sample splits (gridDim.y) the launch below uses; the caller
// allocates part_m and part_s of splits * G floats each.
int kde_logsumexp_splits(int G, int N, int num_sms) {
  const int grid_blocks = (G + kThreads - 1) / kThreads;
  const int tiles = (N + kTile - 1) / kTile;
  // Aim at 8 blocks per SM, each split at least one sample tile.
  int splits = (8 * num_sms + grid_blocks - 1) / grid_blocks;
  splits = splits < 1 ? 1 : splits;
  return splits < tiles ? splits : (tiles < 1 ? 1 : tiles);
}

// Launch on `stream`; returns cudaGetLastError(). The caller checks shapes,
// 1 <= D <= 8 and N >= 1.
int kde_logsumexp(const float* grid, const float* samples, float* part_m,
                  float* part_s, float* out, int G, int N, int D, int splits,
                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (G == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (N + kTile - 1) / kTile;
  const int per_split = ((tiles + splits - 1) / splits) * kTile;
  const dim3 blocks((G + kThreads - 1) / kThreads, splits);
  switch (D) {
    case 1: launch_partial<1>(blocks, st, grid, samples, part_m, part_s, G, N, per_split); break;
    case 2: launch_partial<2>(blocks, st, grid, samples, part_m, part_s, G, N, per_split); break;
    case 3: launch_partial<3>(blocks, st, grid, samples, part_m, part_s, G, N, per_split); break;
    case 4: launch_partial<4>(blocks, st, grid, samples, part_m, part_s, G, N, per_split); break;
    case 5: launch_partial<5>(blocks, st, grid, samples, part_m, part_s, G, N, per_split); break;
    case 6: launch_partial<6>(blocks, st, grid, samples, part_m, part_s, G, N, per_split); break;
    case 7: launch_partial<7>(blocks, st, grid, samples, part_m, part_s, G, N, per_split); break;
    case 8: launch_partial<8>(blocks, st, grid, samples, part_m, part_s, G, N, per_split); break;
    default: return cudaErrorInvalidValue;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kde_combine_kernel<<<(G + 255) / 256, 256, 0, st>>>(part_m, part_s, out, G,
                                                       splits);
  return cudaGetLastError();
}

}  // extern "C"
