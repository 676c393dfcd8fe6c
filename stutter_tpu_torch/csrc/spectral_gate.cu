// Non-stationary spectral gate (noisereduce-equivalent) for Hopper (sm_90a), FP32.
//
// Replaces stutter_tpu/ops/pallas_denoise.py:spectral_gate_pallas (bodies
// _gate_kernel, _affine_scan).  Hop-chunked padded audio [B, C, hop] ->
// overlap-added output [B, T + 3, hop] (T = C - 3 frames, K = n_fft/2 + 1
// bins), in four launches:
//
//  1. chunk_dft + gate_frames: the shared-chunk DFT STFT (chunk_stft.cuh:
//     one GEMM for the chunk DFTs, then phase recombination and the 3-tap
//     Hann per frame tile), writing yr, yi and |Y| [B, T, K] as scratch.
//  2. gate_iir_mask: one thread per (clip, bin) runs noisereduce's
//     filtfilt([b], [1, b-1]) with steady-state starts serially forward and
//     backward over T (adjacent threads take adjacent bins, so loads
//     coalesce), then the sigmoid mask sigmoid(((|Y| - s) / s - thresh) *
//     slope), 0 where s == 0.
//  3. gate_smooth: the separable triangular smoothing as a stencil in
//     shared memory (33 taps in frequency, then 7 in time, zero 'same'
//     padding), the prop_decrease blend, and the multiply into yr, yi.
//  4. gate_istft: the IDFT of each frame against [K, n_fft] tables with the
//     synthesis Hann and 1/N folded in, overlap-added as a gather -- output
//     row r = sum over slots s of slot s of frame r - s -- which makes the
//     whole iSTFT one GEMM (sgemm.cuh) over a depth of RATIO x 2 x K, with no
//     atomics and a deterministic result; times the reciprocal
//     window-sum-square.
//
// Bounds on an H100: the IDFT (launch 4, 2 * T * 2K * n_fft FLOPs: about
// 0.9 GFLOP per clip of the 3 s bucket) and the chunk DFT (0.23 GFLOP) are
// ~95 % of the FLOPs and are FP32 issue-bound on the CUDA cores; launches 2
// and 3 each stream the [B, T, K] scratch through device memory a few times
// (bandwidth-bound), and launch 2 is a serial dependency chain of length 2T
// per thread.
#include "chunk_stft.cuh"

using namespace chunk_stft;

namespace {

constexpr int RATIO = 4;  // n_fft / hop: the gate's only geometry (1024 / 256)

__global__ void gate_frames(const float* __restrict__ Z, int C, int T, int K,
                            const float* __restrict__ pre, const float* __restrict__ pim,
                            float* __restrict__ yr, float* __restrict__ yi,
                            float* __restrict__ mag) {
  extern __shared__ __align__(16) float smem[];
  float* Xr = smem;
  float* Xi = Xr + TF * K;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TF;
  const int tf = min(TF, T - t0);

  recombine_tile<RATIO>(Z, C, K, b, t0, tf, pre, pim, Xr, Xi);
  __syncthreads();

  const size_t o = ((size_t)b * T + t0) * K;
  for (int i = threadIdx.x; i < tf * K; i += blockDim.x) {
    const int t = i / K, k = i - t * K;
    float r, im;
    hann3(Xr + t * K, Xi + t * K, k, K, r, im);
    yr[o + i] = r;
    yi[o + i] = im;
    mag[o + i] = sqrtf(r * r + im * im);
  }
}

constexpr int IIR_UNROLL = 8;  // loads issued ahead of the serial recurrence

__global__ void gate_iir_mask(const float* __restrict__ mag, float* __restrict__ mk, int T, int K,
                              float bb, float a, float thresh, float slope) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const size_t base = (size_t)blockIdx.y * T * K + k;
  const float* m = mag + base;
  float* s = mk + base;
  // forward: y[0] = x[0], y[t] = (1 - b) y[t-1] + b x[t]
  float y = m[0];
  s[0] = y;
  int t = 1;
  for (; t + IIR_UNROLL <= T; t += IIR_UNROLL) {
    float x[IIR_UNROLL];
#pragma unroll
    for (int u = 0; u < IIR_UNROLL; ++u) x[u] = m[(size_t)(t + u) * K];
#pragma unroll
    for (int u = 0; u < IIR_UNROLL; ++u) {
      y = a * y + bb * x[u];
      s[(size_t)(t + u) * K] = y;
    }
  }
  for (; t < T; ++t) {
    y = a * y + bb * m[(size_t)t * K];
    s[(size_t)t * K] = y;
  }
  // backward over the forward pass, then the mask in place of it
  float z = y;
  t = T - 1;
  for (; t - IIR_UNROLL + 1 >= 0; t -= IIR_UNROLL) {
    float f[IIR_UNROLL], x[IIR_UNROLL];
#pragma unroll
    for (int u = 0; u < IIR_UNROLL; ++u) {
      f[u] = s[(size_t)(t - u) * K];
      x[u] = m[(size_t)(t - u) * K];
    }
#pragma unroll
    for (int u = 0; u < IIR_UNROLL; ++u) {
      if (t - u < T - 1) z = a * z + bb * f[u];
      const float above = z > 0.f ? (x[u] - z) / z : 0.f;
      s[(size_t)(t - u) * K] = 1.f / (1.f + expf(-((above - thresh) * slope)));
    }
  }
  for (; t >= 0; --t) {
    if (t < T - 1) z = a * z + bb * s[(size_t)t * K];
    const float mv = m[(size_t)t * K];
    const float above = z > 0.f ? (mv - z) / z : 0.f;
    s[(size_t)t * K] = 1.f / (1.f + expf(-((above - thresh) * slope)));
  }
}

constexpr int SMOOTH_TT = 16;  // output frames per smoothing block
constexpr int MAX_TAPS = 64;   // per axis

__global__ void gate_smooth(const float* __restrict__ mk, float* __restrict__ yr,
                            float* __restrict__ yi, int T, int K,
                            const float* __restrict__ f_taps, int kf,
                            const float* __restrict__ t_taps, int kt, float prop) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float fs[MAX_TAPS], ts[MAX_TAPS];
  const int rows = SMOOTH_TT + kt - 1;
  const int KW = K + kf - 1;    // a mask row with its zero frequency halo
  float* A = smem;              // [rows * KW] mask rows with both halos
  float* F = A + rows * KW;     // [rows * K] frequency-smoothed
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * SMOOTH_TT;
  const int pt = kt / 2, pf = kf / 2;
  const size_t base = (size_t)b * T * K;

  if (threadIdx.x < kf) fs[threadIdx.x] = f_taps[threadIdx.x];
  if (threadIdx.x < kt) ts[threadIdx.x] = t_taps[threadIdx.x];
  for (int i = threadIdx.x; i < rows * KW; i += blockDim.x) {
    const int r = i / KW, k = i - r * KW - pf;
    const int t = t0 - pt + r;
    A[i] = (t >= 0 && t < T && k >= 0 && k < K) ? mk[base + (size_t)t * K + k] : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * K; i += blockDim.x) {
    const int r = i / K, k = i - r * K;
    const float* a = A + r * KW + k;
    float acc = 0.f;
    for (int j = 0; j < kf; ++j) acc += fs[j] * a[j];
    F[i] = acc;
  }
  __syncthreads();
  const int tf = min(SMOOTH_TT, T - t0);
  for (int i = threadIdx.x; i < tf * K; i += blockDim.x) {
    const int t = i / K, k = i - t * K;
    float acc = 0.f;
    for (int j = 0; j < kt; ++j) acc += ts[j] * F[(t + j) * K + k];
    const float m = acc * prop + (1.f - prop);
    const size_t o = base + (size_t)(t0 + t) * K + k;
    yr[o] *= m;
    yi[o] *= m;
  }
}

// Output row r of the overlap-add is the sum over slots s of slot s of
// frame r - s: per slot and part (re, im), A = that part of Y with its rows
// shifted down by s, B = the columns [s * hop, (s + 1) * hop) of the IDFT
// table, accumulated into one tile.
template <int TM>
__global__ void __launch_bounds__(sgemm::THREADS)
    gate_istft(const float* __restrict__ yr, const float* __restrict__ yi,
               const float* __restrict__ cr, const float* __restrict__ ci,
               const float* __restrict__ winv, int T, int K, int hop, int n_fft,
               float* __restrict__ out) {
  constexpr int S = sgemm::Geometry<TM>::S;
  const int b = blockIdx.z;
  const int n_rows = T + RATIO - 1;
  const int m0 = blockIdx.y * S, n0 = blockIdx.x * S;
  const size_t base = (size_t)b * T * K;
  float acc[TM][TM];
  sgemm::zero(acc);
  for (int s = 0; s < RATIO; ++s) {
    for (int part = 0; part < 2; ++part) {
      const sgemm::Dense A{(part ? yi : yr) + base, T, K, K, s};
      const sgemm::Dense W{(part ? ci : cr) + s * hop, K, hop, n_fft, 0};
      sgemm::tile(m0, n0, K, A, W, acc);
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + sgemm::row_of(i);
    if (r >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int c = n0 + sgemm::col_of(j);
      if (c < hop)
        out[((size_t)b * n_rows + r) * hop + c] = acc[i][j] * winv[(size_t)r * hop + c];
    }
  }
}

}  // namespace

extern "C" int spectral_gate_launch(const void* chunks, const void* tab, const void* pre,
                                    const void* pim, const void* f_taps, const void* t_taps,
                                    const void* cr, const void* ci, const void* winv, void* Z,
                                    void* yr, void* yi, void* mag, void* mk, void* out, int B,
                                    int C, int n_fft, int hop, int kf, int kt, float bb, float a,
                                    float thresh, float slope, float prop, void* stream) {
  if (n_fft != RATIO * hop || hop % sgemm::BK != 0 || C < RATIO || kf > MAX_TAPS ||
      kt > MAX_TAPS)
    return (int)cudaErrorInvalidValue;
  const int K = n_fft / 2 + 1;
  const int T = C - RATIO + 1;
  cudaStream_t s = (cudaStream_t)stream;

  // the chunks arrive padded: each clip is C * hop samples, no extra padding
  cudaError_t err = launch_chunk_dft((const float*)chunks, C * hop, B, C, 0, hop,
                                     (const float*)tab, K, (float*)Z, s);
  if (err != cudaSuccess) return (int)err;
  const size_t smem1 = tile_smem_bytes(K);
  err = cudaFuncSetAttribute(gate_frames, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return (int)err;
  gate_frames<<<dim3((T + TF - 1) / TF, B), threads_for(K), smem1, s>>>(
      (const float*)Z, C, T, K, (const float*)pre, (const float*)pim, (float*)yr, (float*)yi,
      (float*)mag);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  gate_iir_mask<<<dim3((K + 127) / 128, B), 128, 0, s>>>((const float*)mag, (float*)mk, T, K, bb,
                                                         a, thresh, slope);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t smem3 = sizeof(float) * (size_t)(SMOOTH_TT + kt - 1) * (2 * K + kf - 1);
  err = cudaFuncSetAttribute(gate_smooth, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem3);
  if (err != cudaSuccess) return (int)err;
  gate_smooth<<<dim3((T + SMOOTH_TT - 1) / SMOOTH_TT, B), 256, smem3, s>>>(
      (const float*)mk, (float*)yr, (float*)yi, T, K, (const float*)f_taps, kf,
      (const float*)t_taps, kt, prop);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int n_rows = T + RATIO - 1;
  const int tm = sgemm::pick_tm(n_rows, hop, B);
  const dim3 grid = sgemm::grid_for(tm, n_rows, hop, B);
  if (tm == 8)
    gate_istft<8><<<grid, sgemm::THREADS, 0, s>>>((const float*)yr, (const float*)yi,
                                                  (const float*)cr, (const float*)ci,
                                                  (const float*)winv, T, K, hop, n_fft,
                                                  (float*)out);
  else
    gate_istft<4><<<grid, sgemm::THREADS, 0, s>>>((const float*)yr, (const float*)yi,
                                                  (const float*)cr, (const float*)ci,
                                                  (const float*)winv, T, K, hop, n_fft,
                                                  (float*)out);
  return (int)cudaGetLastError();
}
