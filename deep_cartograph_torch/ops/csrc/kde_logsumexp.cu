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
// (MUFU, 16 per clock per SM), while the bytes (inputs and output, read
// once) are a few hundred kilobytes. The (G, N) matrix is never written.
// An SM issues 4 warp instructions per clock, so the exp unit sets the pace
// only while a term costs fewer than 4 x 32 / 16 = 8 issue slots.
//
// Design, per term at D = 2 (7 + 9/32 issue slots at R = 4, U = 8):
// - Base 2. A term is ex2(v - m) with v = -d2 * log2(e): the differences
//   are taken on the caller's inputs, exactly as the plain version takes
//   them (so large coordinates lose no more than there), and log2(e) and
//   the running max fold into one FMA: 2 FADD + 1 FMUL + 2 FFMA for d2 and
//   t, one MUFU.EX2 (ex2.approx.ftz, no range reduction), one FADD into the
//   sum. No multiply inside an expf, no compare, no select.
// - R grid points per thread. A sample is read from shared memory once, as
//   a vector (two samples per LDS.128 at D = 2, float4s above) broadcast to
//   the warp, and used R times; the R sums are independent chains and U
//   samples are unrolled, so R x U exps are in flight per thread.
// - A lazy running max, checked once per chunk of kChunk samples and grid
//   point, not per term. m starts at the max of the split's first kProbe
//   terms, rounded to an integer (a pass without exps: 2D + 1 slots a
//   term). Terms ex2(v - m) are summed per chunk; after the chunk:
//     * the chunk sum is finite: add it; if the sum passes 2^32, move m up
//       by the sum's exponent and scale the sum by that power of two
//       (exact);
//     * the sum overflowed (a sample more than ~128 octaves nearer than
//       m): that grid point redoes the chunk in two passes, its exact max
//       first, then the sum. Rare, inside the kernel, and a chunk is short
//       so the warp waits little.
//   m stays an integer (exact) and never exceeds log2 of the sum by more
//   than 1/2, so a term that flushes to 0 (below 2^(m - 126)) is below
//   2^-125 of the sum.
// - Filling the card. The sample range is split over gridDim.y, as many
//   splits as fill every SM with resident blocks in one wave; each split
//   writes a partial (m, s) in base 2 and a second kernel merges the splits
//   and applies ln2 * (m + log2(max(s, 1e-38))), as the TPU kernel applies
//   m + log(max(s, 1e-38)). Samples past N are never visited, so the
//   ragged end needs no sentinel rows and contributes exactly 0.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 4;        // R: grid points per thread
constexpr int kUnroll = 8;      // U: samples per unrolled step
constexpr int kTile = 512;      // samples per shared-memory tile
constexpr int kChunk = 128;     // samples per lazy check
constexpr int kProbe = 32;      // samples that set a split's first m
constexpr int kPoints = kThreads * kRows;  // grid points per block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kRescaleAbove = 4294967296.f;  // 2^32

// Shared-memory stride of one sample: a vector width.
template <int D>
constexpr int kPad = D == 1 ? 1 : D == 2 ? 2 : D <= 4 ? 4 : 8;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
__device__ __forceinline__ void load_sample(const float* p, float (&x)[D]) {
  if constexpr (D == 1) {
    x[0] = p[0];
  } else if constexpr (D == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x;
    x[1] = v.y;
  } else {
#pragma unroll
    for (int h = 0; h < (D + 3) / 4; ++h) {
      const float4 v = reinterpret_cast<const float4*>(p)[h];
      const float c[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * h + k < D) x[4 * h + k] = c[k];
    }
  }
}

template <int D>
__device__ __forceinline__ float dist2(const float (&q)[D], const float (&x)[D]) {
  float d2 = 0.f;
#pragma unroll
  for (int k = D - 1; k >= 0; --k) {
    const float d = q[k] - x[k];
    d2 = fmaf(d, d, d2);
  }
  return d2;
}

// Exact update of one grid point's (m, s) with a chunk whose lazy sum
// overflowed: the chunk's max first, then its terms below the new m.
// Inlined, so that q stays in registers.
template <int D>
__device__ __forceinline__ void redo_chunk(const float* chunk, int n,
                                        const float (&q)[D], float& m,
                                        float& s) {
  constexpr int P = kPad<D>;
  float vmax = -INFINITY;
  for (int j = 0; j < n; ++j) {
    float x[D];
    load_sample<D>(chunk + j * P, x);
    vmax = fmaxf(vmax, -dist2<D>(q, x) * kLog2e);
  }
  const float m_new = fmaxf(m, rintf(vmax));
  float acc = s * exp2f(m - m_new);
  for (int j = 0; j < n; ++j) {
    float x[D];
    load_sample<D>(chunk + j * P, x);
    acc += ex2(fmaf(dist2<D>(q, x), -kLog2e, -m_new));
  }
  m = m_new;
  s = acc;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
kde_partial_kernel(const float* __restrict__ grid,
                   const float* __restrict__ samples,
                   float* __restrict__ part_m, float* __restrict__ part_s,
                   int G, int N, int per_split) {
  constexpr int P = kPad<D>;
  __shared__ __align__(16) float tile[kTile * P];
  const int g0 = blockIdx.x * kPoints + threadIdx.x;  // rows g0 + r * kThreads
  const int n0 = blockIdx.y * per_split;
  const int n1 = min(N, n0 + per_split);

  float q[kRows][D];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int g = g0 + r * kThreads;
#pragma unroll
    for (int k = 0; k < D; ++k) q[r][k] = g < G ? grid[(size_t)g * D + k] : 0.f;
  }

  float m[kRows], s[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    s[r] = 0.f;
  }
  for (int t0 = n0; t0 < n1; t0 += kTile) {
    const int nt = min(kTile, n1 - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < nt * D; i += kThreads)
      tile[(i / D) * P + i % D] = samples[(size_t)t0 * D + i];
    __syncthreads();

    if (t0 == n0) {  // the split's first m: its first kProbe terms' max
      const int np = min(kProbe, nt);
      float vmax[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) vmax[r] = -INFINITY;
      for (int j = 0; j < np; ++j) {
        float x[D];
        load_sample<D>(tile + j * P, x);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          vmax[r] = fmaxf(vmax[r], -dist2<D>(q[r], x));
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) m[r] = rintf(vmax[r] * kLog2e);
    }

    for (int c0 = 0; c0 < nt; c0 += kChunk) {
      const float* chunk = tile + c0 * P;
      const int nc = min(kChunk, nt - c0);
      float neg_m[kRows], st[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        neg_m[r] = -m[r];
        st[r] = 0.f;
      }
      int j = 0;
      for (; j + kUnroll <= nc; j += kUnroll) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float x[D];
          load_sample<D>(chunk + (j + u) * P, x);
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            st[r] += ex2(fmaf(dist2<D>(q[r], x), -kLog2e, neg_m[r]));
        }
      }
      for (; j < nc; ++j) {
        float x[D];
        load_sample<D>(chunk + j * P, x);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          st[r] += ex2(fmaf(dist2<D>(q[r], x), -kLog2e, neg_m[r]));
      }

#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (isinf(s[r] + st[r]))
          redo_chunk<D>(chunk, nc, q[r], m[r], s[r]);
        else
          s[r] += st[r];
        if (s[r] > kRescaleAbove) {  // s = 2^k * f, f in [1, 2)
          const int k = (__float_as_int(s[r]) >> 23) - 127;
          s[r] = __int_as_float(__float_as_int(s[r]) - (k << 23));
          m[r] += (float)k;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int g = g0 + r * kThreads;
    if (g < G) {
      part_m[(size_t)blockIdx.y * G + g] = m[r];
      part_s[(size_t)blockIdx.y * G + g] = s[r];
    }
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
    if (sy > 0.f) s = fmaf(sy, exp2f(part_m[(size_t)y * G + g] - m), s);
  }
  out[g] = kLn2 * (m + log2f(fmaxf(s, 1e-38f)));
}

template <int D>
void launch_partial(dim3 blocks, cudaStream_t stream, const float* grid,
                    const float* samples, float* part_m, float* part_s, int G,
                    int N, int per_split) {
  kde_partial_kernel<D><<<blocks, kThreads, 0, stream>>>(
      grid, samples, part_m, part_s, G, N, per_split);
}

template <int D>
int resident_blocks() {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kde_partial_kernel<D>,
                                                kThreads, 0);
  return blocks;
}

int tiles_per_split(int N, int splits) {
  const int tiles = (N + kTile - 1) / kTile;
  return (tiles + splits - 1) / splits;
}

}  // namespace

extern "C" {

const char* dc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Number of sample splits (gridDim.y) the launch below uses, none of them
// empty; the caller allocates part_m and part_s of splits * G floats each.
// As many as fill the card in one wave of resident blocks, each split at
// least one sample tile.
int kde_logsumexp_splits(int G, int N, int D, int num_sms) {
  int resident = 0;
  switch (D) {
    case 1: resident = resident_blocks<1>(); break;
    case 2: resident = resident_blocks<2>(); break;
    case 3: resident = resident_blocks<3>(); break;
    case 4: resident = resident_blocks<4>(); break;
    case 5: resident = resident_blocks<5>(); break;
    case 6: resident = resident_blocks<6>(); break;
    case 7: resident = resident_blocks<7>(); break;
    default: resident = resident_blocks<8>(); break;
  }
  const int grid_blocks = (G + kPoints - 1) / kPoints;
  const int tiles = (N + kTile - 1) / kTile;
  int splits = (resident > 0 ? resident : 1) * num_sms / (grid_blocks > 0 ? grid_blocks : 1);
  splits = splits < 1 ? 1 : (splits > tiles ? tiles : splits);
  const int per = tiles_per_split(N, splits);
  return (tiles + per - 1) / per;
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
  const int per_split = tiles_per_split(N, splits) * kTile;
  const dim3 blocks((G + kPoints - 1) / kPoints, splits);
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
