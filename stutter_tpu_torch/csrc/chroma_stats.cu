// Chroma-apply + statistics kernel for Hopper (sm_90a), FP32.
//
// Replaces stutter_tpu/ops/pallas_chroma.py:chroma_stats_pallas (body
// _chroma_stats_kernel).  One block per clip: the clip's 12 filterbank rows
// (tuning bin tb -> rows tb * 12 ... of the [100 * 12, K] table) are staged
// in shared memory; each warp takes frames and forms the 12 dot products of
// a power frame against them (raw = power . fbk^T), inf-normalises the frame
// (a max below f32 tiny divides by 1), and keeps the chroma in shared
// memory; the block then takes the masked population mean and std over the
// valid frames -> [B, 24].
//
// Bounds on an H100: it reads the power spectrogram once (102 MB for a
// batch of 256 clips of 3 s) and does 12 FMAs per value read, so it is bound
// by device-memory bandwidth.  Frames past n_valid are not read at all.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NCH = 12;
constexpr float F32_TINY = 1.17549435e-38f;

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void chroma_stats_kernel(const float* __restrict__ power, const int* __restrict__ tb,
                                    const int* __restrict__ n_valid,
                                    const float* __restrict__ table, int n_rows, int T, int K,
                                    float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* fbk = smem;           // [NCH * K]
  float* chroma = fbk + NCH * K;  // [T * NCH]

  const int b = blockIdx.x;
  const int nv = min(max(n_valid[b], 0), T);
  // an out-of-range bin would read outside the table: clamp to its ends
  const int bin = min(max(tb[b], 0), n_rows / NCH - 1);
  const float* rows = table + (size_t)bin * NCH * K;
  for (int i = threadIdx.x; i < NCH * K; i += blockDim.x) fbk[i] = rows[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int t = warp; t < nv; t += nwarps) {
    const float* p = power + ((size_t)b * T + t) * K;
    float acc[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc[c] = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float v = p[k];
#pragma unroll
      for (int c = 0; c < NCH; ++c) acc[c] += v * fbk[c * K + k];
    }
    float denom = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      acc[c] = warp_sum(acc[c]);
      denom = fmaxf(denom, fabsf(acc[c]));
    }
    if (denom < F32_TINY) denom = 1.f;
    if (lane < NCH) {
      float v = 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) v = (c == lane) ? acc[c] : v;
      chroma[t * NCH + lane] = v / denom;
    }
  }
  __syncthreads();

  const float cnt = (float)max(nv, 1);
  for (int c = warp; c < NCH; c += nwarps) {
    float s = 0.f;
    for (int t = lane; t < nv; t += 32) s += chroma[t * NCH + c];
    const float mean = warp_sum(s) / cnt;
    float v = 0.f;
    for (int t = lane; t < nv; t += 32) {
      const float d = chroma[t * NCH + c] - mean;
      v += d * d;
    }
    const float stdv = sqrtf(warp_sum(v) / cnt);
    if (lane == 0) {
      out[(size_t)b * 2 * NCH + c] = mean;
      out[(size_t)b * 2 * NCH + NCH + c] = stdv;
    }
  }
}

}  // namespace

extern "C" int chroma_stats_launch(const void* power, const void* tb, const void* n_valid,
                                   const void* table, void* out, int B, int T, int K,
                                   int n_rows, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)NCH * K + (size_t)T * NCH);
  cudaError_t err = cudaFuncSetAttribute(chroma_stats_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  chroma_stats_kernel<<<B, 256, smem, (cudaStream_t)stream>>>(
      (const float*)power, (const int*)tb, (const int*)n_valid, (const float*)table, n_rows, T,
      K, (float*)out);
  return (int)cudaGetLastError();
}
