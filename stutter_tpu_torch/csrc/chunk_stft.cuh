// Shared-chunk STFT, used by spectromel.cu and spectral_gate.cu.
//
// Frames at hop h overlap R = n_fft / h times, and each hop chunk's DFT is
// shared by the R frames that contain it up to a phase:
//   X_t[k] = sum_c e^{-2 pi i c h k / n_fft} Z_{t+c}[k],
//   Z_j[k] = sum_q chunk_j[q] e^{-2 pi i q k / n_fft},
// an R-fold saving over framing.  The periodic Hann window is applied
// afterwards in frequency as its exact 3-tap spectrum,
//   Y[k] = 0.5 X[k] - 0.25 (X[k-1] + X[k+1]),
// with the conjugate-symmetric neighbours at DC and Nyquist.
//
// This is the formulation of the TPU kernels (pallas_spectromel.py:194,
// pallas_denoise.py:177) in FP32 without their bf16 splits.  Here it is two
// steps: `chunk_dft`, one GEMM Z = chunks [B * C, hop] x [cos | sin]
// [hop, 2K] (sgemm.cuh) whose A operand is read straight from the signal, so
// no chunk matrix is built; then each kernel's frame-tile epilogue, which
// recombines X from Z (`recombine_tile<R>`) and applies `hann3`.  The ratio R
// is a template parameter: a clip of N samples padded by n_fft / 2 on each
// side has C = N / h + R hop chunks and T = N / h + 1 = C - R + 1 frames.
// The phase factors are exact 0 / +-1 for R = 2 and 4.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "sgemm.cuh"

namespace chunk_stft {

constexpr int TF = 8;  // frames per epilogue tile

// Threads for a loop over K bins: the fewest passes of at most 256
// threads, rounded up to whole warps.
inline int threads_for(int K) {
  int passes = (K + 255) / 256;
  int t = (K + passes - 1) / passes;
  return (t + 31) / 32 * 32;
}

// A(r, q): sample q of chunk c = r % C of clip b = r / C, where clip b is
// the n samples at sig + b * n preceded by `pad` zeros (zeros after).
struct Chunks {
  const float* sig;
  int n, C, pad, hop, rows;
  __device__ float operator()(int r, int q) const {
    if (r >= rows) return 0.f;
    const int b = r / C;
    const long pos = (long)(r - b * C) * hop - pad + q;
    return (pos >= 0 && pos < n) ? sig[(size_t)b * n + pos] : 0.f;
  }
};

// Z [B * C, 2K] (re in columns [0, K), im in [K, 2K)) of the hop chunks.
template <int TM>
__global__ void __launch_bounds__(sgemm::THREADS)
    chunk_dft(Chunks A, sgemm::Dense tab, float* __restrict__ Z) {
  constexpr int S = sgemm::Geometry<TM>::S;
  float acc[TM][TM];
  sgemm::zero(acc);
  sgemm::tile(blockIdx.y * S, blockIdx.x * S, A.hop, A, tab, acc);
  sgemm::store(Z, A.rows, tab.cols, tab.cols, blockIdx.y * S, blockIdx.x * S, acc);
}

inline cudaError_t launch_chunk_dft(const float* sig, int n, int B, int C, int pad, int hop,
                                    const float* tab, int K, float* Z, cudaStream_t s) {
  const Chunks A{sig, n, C, pad, hop, B * C};
  const sgemm::Dense T{tab, hop, 2 * K, 2 * K, 0};
  const int tm = sgemm::pick_tm(B * C, 2 * K, 1);
  const dim3 grid = sgemm::grid_for(tm, B * C, 2 * K, 1);
  if (tm == 8)
    chunk_dft<8><<<grid, sgemm::THREADS, 0, s>>>(A, T, Z);
  else
    chunk_dft<4><<<grid, sgemm::THREADS, 0, s>>>(A, T, Z);
  return cudaGetLastError();
}

// Xr/Xi[t * K + k] = X_{t0+t}[k] (unwindowed) of clip b, for t < tf, from
// Z rows b * C + t0 + t + c (c < R) and the phase tables pre/pim [R, K].
template <int R>
__device__ inline void recombine_tile(const float* __restrict__ Z, int C, int K, int b, int t0,
                                      int tf, const float* __restrict__ pre,
                                      const float* __restrict__ pim, float* Xr, float* Xi) {
  for (int i = threadIdx.x; i < tf * K; i += blockDim.x) {
    const int t = i / K, k = i - t * K;
    const float* z = Z + ((size_t)b * C + t0 + t) * 2 * K + k;
    float xr = 0.f, xi = 0.f;
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const float zr = z[(size_t)c * 2 * K], zi = z[(size_t)c * 2 * K + K];
      const float fr = pre[c * K + k], fi = pim[c * K + k];
      xr += fr * zr - fi * zi;
      xi += fr * zi + fi * zr;
    }
    Xr[i] = xr;
    Xi[i] = xi;
  }
}

// Hann-windowed bin k of frame row (r, i) of K bins: the exact 3-tap filter.
__device__ inline void hann3(const float* r, const float* i, int k, int K, float& yr,
                             float& yi) {
  if (k == 0) {
    yr = 0.5f * r[0] - 0.5f * r[1];
    yi = 0.5f * i[0];
  } else if (k == K - 1) {
    yr = 0.5f * r[K - 1] - 0.5f * r[K - 2];
    yi = 0.5f * i[K - 1];
  } else {
    yr = 0.5f * r[k] - 0.25f * (r[k - 1] + r[k + 1]);
    yi = 0.5f * i[k] - 0.25f * (i[k - 1] + i[k + 1]);
  }
}

inline size_t tile_smem_bytes(int K) { return sizeof(float) * 2 * (size_t)TF * K; }

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ inline float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace chunk_stft
