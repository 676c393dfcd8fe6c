// Register-tiled FP32 GEMM tile on CUDA cores, shared by the port's kernels.
//
// One block of 256 threads (16 x 16) accumulates a square tile of
//   C[m, n] += sum_k A(m, k) * B(k, n),
// each thread holding TM x TM accumulators: TM = 8 gives 128 x 128 tiles,
// TM = 4 gives 64 x 64 tiles.  A and B are loader functors
// (`float operator()(int, int) const`, returning 0 outside the matrix), so
// one routine serves the chunk DFT (A = hop chunks read straight from the
// padded signal), the mel product and the overlap-add IDFT (A = frames
// shifted by their slot).  k tiles of 8 are double-buffered in shared
// memory: the next tile's global loads are in flight while the current one
// is multiplied.  Each value loaded feeds 16 * TM FMAs.
//
// Large tiles reuse loads best; small ones give 4x the blocks, which is what
// a single request's shapes need to fill the card's SMs.  `pick_tm` chooses
// from the grid size.
//
// FP32 throughout: the parity bounds (power relative error 1e-5) rule out
// TF32 tensor cores, which keep 10 mantissa bits.
#pragma once

#include <cuda_runtime.h>

namespace sgemm {

constexpr int BK = 8, THREADS = 256;

template <int TM>
struct Geometry {
  static constexpr int S = 16 * TM;  // tile rows = tile columns
};

// Row / column within the tile of accumulator i / j of this thread.
__device__ inline int row_of(int i) { return (i >> 2) * 64 + (threadIdx.x >> 4) * 4 + (i & 3); }
__device__ inline int col_of(int j) { return (j >> 2) * 64 + (threadIdx.x & 15) * 4 + (j & 3); }

template <int TM>
__device__ inline void zero(float (&acc)[TM][TM]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;
}

template <int TM, class ALoad, class BLoad>
__device__ inline void tile(int m0, int n0, int K, const ALoad& A, const BLoad& B,
                            float (&acc)[TM][TM]) {
  constexpr int S = Geometry<TM>::S;
  constexpr int LOADS = S * BK / THREADS;  // per thread and operand
  __shared__ __align__(16) float As[2][BK][S + 4];  // k-major; +4 avoids store conflicts
  __shared__ __align__(16) float Bs[2][BK][S];
  const int tid = threadIdx.x;
  const int ty4 = (tid >> 4) * 4, tx4 = (tid & 15) * 4;
  float ra[LOADS], rb[LOADS];

  // (a previous call on this tile ended at a barrier after its last reads)
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    const int e = tid + THREADS * u;
    ra[u] = A(m0 + (e >> 3), e & 7);
    rb[u] = B(e / S, n0 + e % S);
  }
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    const int e = tid + THREADS * u;
    As[0][e & 7][e >> 3] = ra[u];
    Bs[0][e / S][e % S] = rb[u];
  }
  __syncthreads();

  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) {
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int e = tid + THREADS * u;
        ra[u] = A(m0 + (e >> 3), k0 + BK + (e & 7));
        rb[u] = B(k0 + BK + e / S, n0 + e % S);
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TM];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) {
        const float4 av = *reinterpret_cast<const float4*>(&As[buf][kk][g * 64 + ty4]);
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[buf][kk][g * 64 + tx4]);
        a[4 * g] = av.x, a[4 * g + 1] = av.y, a[4 * g + 2] = av.z, a[4 * g + 3] = av.w;
        b[4 * g] = bv.x, b[4 * g + 1] = bv.y, b[4 * g + 2] = bv.z, b[4 * g + 3] = bv.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] += a[i] * b[j];
    }
    if (more) {
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int e = tid + THREADS * u;
        As[buf ^ 1][e & 7][e >> 3] = ra[u];
        Bs[buf ^ 1][e / S][e % S] = rb[u];
      }
    }
    __syncthreads();
    buf ^= 1;
  }
}

// Row-major matrix [rows, cols] with leading dimension ld whose row r is
// stored at row r - shift; 0 outside.
struct Dense {
  const float* p;
  int rows, cols, ld, shift;
  __device__ float operator()(int r, int c) const {
    r -= shift;
    return (r >= 0 && r < rows && c < cols) ? p[(size_t)r * ld + c] : 0.f;
  }
};

// acc -> row-major out [rows, cols] (ld) at tile (m0, n0), dropping the
// ragged edge.
template <int TM>
__device__ inline void store(float* out, int rows, int cols, int ld, int m0, int n0,
                             const float (&acc)[TM][TM]) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + row_of(i);
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int c = n0 + col_of(j);
      if (c < cols) out[(size_t)r * ld + c] = acc[i][j];
    }
  }
}

// 8 (128 x 128 tiles) when that grid has at least 8 blocks per SM (about
// four full waves at two resident blocks per SM), else 4 (64 x 64 tiles).
// Measured on an H100: the chunk DFT of 256 clips (3400 large tiles) runs
// faster with large tiles, the iSTFT of 64 clips (512 large tiles) and
// every single-request shape faster with small ones.
inline int pick_tm(long rows, long cols, long batch) {
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  }
  const long blocks = ((rows + 127) / 128) * ((cols + 127) / 128) * batch;
  return blocks >= 8L * n_sm ? 8 : 4;
}

inline dim3 grid_for(int tm, long rows, long cols, long batch) {
  const long s = 16L * tm;
  return dim3((unsigned)((cols + s - 1) / s), (unsigned)((rows + s - 1) / s), (unsigned)batch);
}

}  // namespace sgemm
