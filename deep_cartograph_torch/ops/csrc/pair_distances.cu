// K1: pair distances for the featurization engine, CUDA C++ for Hopper.
//
// Replaces the TPU kernel ops/pallas_kernels.py::selector_pair_distances
// (body _seldist_kernel) of the JAX package, and with it the distance segment
// of geom/kernels.py::_evaluate_plan_chunk, which is what the JAX main path
// runs. The TPU form contracts coordinates with a dense +/-1 (A, P) selector
// on the matrix unit; here each pair reads its two atoms directly, which is
// exact and costs 6 flops per pair instead of 2*A.
//
//   out[c, p] = 0.1 * sqrt(sum_axis (pts[c, a_p, axis] - pts[c, b_p, axis])^2)
//   points (C, N, 3) f32 Angstrom, pairs (P, 2) int32, out (C, P) f32 nm.
//
// Bound on the H100: bytes. Each frame-pair costs 4 output bytes against
// ~10 flops, so writing the output (C*P*4 bytes) is the limit; the points
// (C*N*12 bytes) and the pair list are read once.
//
// Design: one block per tile of TF frames. The block copies the tile's
// points (contiguous in memory) with coalesced loads into shared memory,
// transposed to one array per axis. Threads then stride over pairs: each
// thread loads its pair's indices once and writes that pair's distance for
// every frame of the tile, so consecutive threads write consecutive columns
// (coalesced stores). The per-axis layout keeps the shared-memory reads of
// consecutive pairs (i, j), (i, j+1), ... free of bank conflicts. Frames
// past C are never read or written (the ragged last tile is masked). The
// host does not check the indices on each call (that would wait for the
// device); a pair with an index outside [0, N) reads nothing and gives NaN.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFramesPerBlock = 8;
constexpr int kDefaultSmem = 48 * 1024;

__global__ void __launch_bounds__(kThreads)
pair_distances_kernel(const float* __restrict__ points,
                      const int2* __restrict__ pairs,
                      float* __restrict__ out,
                      int C, int N, int P, int frames_per_block) {
  extern __shared__ float tile[];  // [frames][axis][atom]
  const int c0 = blockIdx.x * frames_per_block;
  const int nf = min(frames_per_block, C - c0);
  const int per_frame = 3 * N;

  const float* src = points + (size_t)c0 * per_frame;
  for (int i = threadIdx.x; i < nf * per_frame; i += kThreads) {
    const int f = i / per_frame;
    const int r = i - f * per_frame;
    const int atom = r / 3;
    const int axis = r - 3 * atom;
    tile[(f * 3 + axis) * N + atom] = src[i];
  }
  __syncthreads();

  for (int p = threadIdx.x; p < P; p += kThreads) {
    const int2 ab = pairs[p];
    float* dst = out + (size_t)c0 * P + p;
    if ((unsigned)ab.x >= (unsigned)N || (unsigned)ab.y >= (unsigned)N) {
      for (int f = 0; f < nf; ++f) dst[(size_t)f * P] = __int_as_float(0x7fc00000);
      continue;
    }
    for (int f = 0; f < nf; ++f) {
      const float* s = tile + f * per_frame;
      const float dx = s[ab.x] - s[ab.y];
      const float dy = s[N + ab.x] - s[N + ab.y];
      const float dz = s[2 * N + ab.x] - s[2 * N + ab.y];
      dst[(size_t)f * P] = sqrtf(dx * dx + dy * dy + dz * dz) * 0.1f;
    }
  }
}

}  // namespace

extern "C" {

const char* dc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Largest shared-memory tile a block may use on this device (bytes).
int pair_distances_max_smem(int device) {
  int bytes = 0;
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  return bytes;
}

// Launch on `stream`; returns cudaGetLastError(). The caller checks shapes
// and that N * 12 bytes fit in shared memory.
int pair_distances(const float* points, const int* pairs, float* out, int C,
                   int N, int P, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (C == 0 || P == 0) return cudaSuccess;
  const size_t frame_bytes = (size_t)N * 3 * sizeof(float);
  int frames = (int)(kDefaultSmem / frame_bytes);
  frames = frames < 1 ? 1 : (frames > kMaxFramesPerBlock ? kMaxFramesPerBlock
                                                          : frames);
  const size_t smem = frames * frame_bytes;
  if (smem > kDefaultSmem) {
    err = cudaFuncSetAttribute(pair_distances_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (C + frames - 1) / frames;
  pair_distances_kernel<<<blocks, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      points, reinterpret_cast<const int2*>(pairs), out, C, N, P, frames);
  return cudaGetLastError();
}

}  // extern "C"
