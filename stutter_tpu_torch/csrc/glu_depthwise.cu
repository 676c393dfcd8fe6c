// W2V-BERT 2.0's conv module core for Hopper (sm_90a), FP32: the GLU and
// the causal depthwise conv over packed clip rows, channels last.
//
// Replaces no TPU kernel: the JAX package has no W2V-BERT.  It was added
// because the conv module, built from PyTorch calls, ran the GLU as its own
// pass, then the 31-tap depthwise conv channels first (ATen's
// conv_depthwise2d between two transposing copies) over a padded batch, and
// because the encoder keeps its rows packed (models/w2v_bert.py: clip b's
// rows are offsets[b] .. offsets[b + 1] - 1 of [R, C]), where a conv over
// the whole sequence would read the previous clip.  This kernel computes
//
//   y[r, c] = sum_{k < K} w[c, k] g[r - K + 1 + k, c],
//   g[j, c] = x[j, c] sigmoid(x[j, C + c])   for j >= s(r), else 0,
//
// s(r) the first row of r's clip, from x [R, 2 C] (the first pointwise
// conv's output) to y [R, C].
//
// Bound on an H100: bytes.  Each output value reads two inputs and writes
// one, 12 bytes of device memory, against 2 x 31 + ~4 operations, so at
// 3.35 TB/s and 67 TFLOP/s the bytes take ~7x the operations' time: at the
// corpus cell's 104,330 rows x 1024 channels x 24 layers a pass, 30.8 GB,
// ~9 ms.  So the design reads each input once from device memory, with
// 16-byte loads, and keeps the window in shared memory and registers:
//
//  * a block of 256 threads owns ROWS = 64 output rows x CH = 32 channels;
//    it loads the GLU's two halves of rows r0 - 30 .. r0 + 63 (16-byte
//    loads along channels, all of a thread's in flight before any is used),
//    applies the GLU as it stores them into shared memory, and stages the
//    32 x 31 weights beside them (a channel's taps at a stride of 31
//    floats, so a warp's 32 channels fall on 32 banks).  The 30 halo rows
//    are read again by the block above, from L2;
//  * each thread owns one channel and RPT = 8 consecutive output rows: it
//    reads the 8 + 30 inputs of its window from shared memory once into
//    registers and runs 8 x 31 FMAs, each tap's weight read once for the
//    8 rows;
//  * each output row's clip start comes from a binary search of the
//    offsets in the prologue, one row a thread.  Where a thread's window
//    lies inside one clip (every row but a clip's first 30 and the packed
//    batch's first rows) the taps run unmasked; else each tap past its
//    row's clip start is replaced by zero, in the same order of summation;
//  * no padded row and no copy: the output is [R, C], row for row.
//
// A second instantiation, `glu_conv_silu_kernel`, is Parakeet's conv
// module core (models/parakeet.py): the GLU, a centred 9-tap depthwise conv
// with a bias, and SiLU, BatchNorm (eval) folded into the taps and the bias
// when the weights are loaded:
//
//   y[r, c] = silu(b[c] + sum_{k < 9} w[c, k] g[r - 4 + k, c]),
//
// g zero outside r's clip on both sides.  It is the same body with the
// window centred (4 rows of halo above the tile, 4 below), each row's clip
// end read beside its start, and the bias and SiLU as the epilogue: one
// launch, each input read once from device memory, the output written
// once.
//
// No --use_fast_math (see _build.py): the sigmoid is 1 / (1 + expf(-x)).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int ROWS = 64;     // output rows a block
constexpr int CH = 32;       // channels a block
constexpr int THREADS = 256;
constexpr int RPT = 8;                     // output rows a thread
constexpr int VEC = CH / 4;                // float4 a staged row's half

static_assert(THREADS == CH * (ROWS / RPT), "one thread a channel and RPT rows");

// K taps; CENTRED: the window r - (K - 1) / 2 .. r + (K - 1) / 2 within the
// clip, with the bias and SiLU after it; else causal, r - K + 1 .. r, no
// bias.
template <int K, bool CENTRED>
__device__ __forceinline__ void conv_block(const float* __restrict__ x, const float* __restrict__ w,
                                           const float* __restrict__ bias,
                                           const int* __restrict__ offsets, float* __restrict__ y,
                                           int R, int C, int B) {
  constexpr int HALO = CENTRED ? (K - 1) / 2 : K - 1;  // rows before a tile that its first row reads
  constexpr int IN_ROWS = ROWS + K - 1;                // staged rows a block
  constexpr int LOADS = (IN_ROWS * VEC + THREADS - 1) / THREADS;  // float4 pairs a thread
  __shared__ __align__(16) float G[IN_ROWS * CH];  // g of rows r0 - HALO .. r0 + ROWS + K - 2 - HALO
  __shared__ float Ws[CH * K];
  // each output row's clip start, and (CENTRED) its clip's end
  __shared__ int bounds[CENTRED ? 2 * ROWS : ROWS];
  int* start = bounds;
  int* end = bounds + ROWS;
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * ROWS, c0 = blockIdx.y * CH;

  // the GLU's halves of every staged row, all loads issued first
  float4 a[LOADS], gate[LOADS];
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    const int e = tid + u * THREADS, j = e / VEC, q = e % VEC;
    const long row = (long)r0 - HALO + j;
    a[u] = gate[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < IN_ROWS && row >= 0 && row < R) {
      const float* src = x + row * (2L * C) + c0 + 4 * q;
      a[u] = __ldg(reinterpret_cast<const float4*>(src));
      gate[u] = __ldg(reinterpret_cast<const float4*>(src + C));
    }
  }
  for (int e = tid; e < CH * K; e += THREADS) Ws[e] = __ldg(w + (long)c0 * K + e);
  if (tid < ROWS) {  // the largest offset at or below the row: its clip's start
    const int r = r0 + tid;
    int lo = 0, hi = B;  // offsets[lo] <= r < offsets[hi] while r < R
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(offsets + mid) <= r) lo = mid; else hi = mid;
    }
    start[tid] = __ldg(offsets + lo);
    if constexpr (CENTRED) end[tid] = __ldg(offsets + lo + 1);
  }
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    const int e = tid + u * THREADS, j = e / VEC, q = e % VEC;
    if (j < IN_ROWS) {
      float4 g;
      g.x = a[u].x * (1.f / (1.f + expf(-gate[u].x)));
      g.y = a[u].y * (1.f / (1.f + expf(-gate[u].y)));
      g.z = a[u].z * (1.f / (1.f + expf(-gate[u].z)));
      g.w = a[u].w * (1.f / (1.f + expf(-gate[u].w)));
      *reinterpret_cast<float4*>(G + j * CH + 4 * q) = g;
    }
  }
  __syncthreads();

  const int c = tid % CH, t0 = (tid / CH) * RPT;  // channel; first output row in the tile
  if (r0 + t0 >= R) return;
  float in[RPT + K - 1], acc[RPT];
#pragma unroll
  for (int j = 0; j < RPT + K - 1; ++j) in[j] = G[(t0 + j) * CH + c];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
  const float* wc = Ws + c * K;
  // starts and ends rise with the row: the last row's start is the
  // window's largest, the first row's end its smallest
  bool inside = start[t0 + RPT - 1] <= r0 + t0 - HALO;
  if constexpr (CENTRED) inside = inside && end[t0] >= r0 + t0 + RPT + K - 1 - HALO;
  if (inside) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float wk = wc[k];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] = fmaf(wk, in[i + k], acc[i]);
    }
  } else if constexpr (CENTRED) {
    int first[RPT], last[RPT];  // a row's taps inside its clip: first .. last - 1
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      first[i] = start[t0 + i] - (r0 + t0 + i - HALO);
      last[i] = end[t0 + i] - (r0 + t0 + i - HALO);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float wk = wc[k];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        acc[i] = fmaf(wk, k >= first[i] && k < last[i] ? in[i + k] : 0.f, acc[i]);
    }
  } else {
    int first[RPT];  // a row's first tap inside its clip
#pragma unroll
    for (int i = 0; i < RPT; ++i) first[i] = start[t0 + i] - (r0 + t0 + i - HALO);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float wk = wc[k];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] = fmaf(wk, k >= first[i] ? in[i + k] : 0.f, acc[i]);
    }
  }
  float bc = 0.f;
  if constexpr (CENTRED) bc = __ldg(bias + c0 + c);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + t0 + i;
    float a = acc[i];
    if constexpr (CENTRED) {
      a += bc;
      a = a * (1.f / (1.f + expf(-a)));
    }
    if (r < R) y[(long)r * C + c0 + c] = a;
  }
}

__global__ void __launch_bounds__(THREADS, 3)
    glu_depthwise_kernel(const float* __restrict__ x, const float* __restrict__ w,
                         const int* __restrict__ offsets, float* __restrict__ y, int R, int C,
                         int B) {
  conv_block<31, false>(x, w, nullptr, offsets, y, R, C, B);
}

__global__ void __launch_bounds__(THREADS, 3)
    glu_conv_silu_kernel(const float* __restrict__ x, const float* __restrict__ w,
                         const float* __restrict__ bias, const int* __restrict__ offsets,
                         float* __restrict__ y, int R, int C, int B) {
  conv_block<9, true>(x, w, bias, offsets, y, R, C, B);
}

}  // namespace

// x [R, 2 C] float32, contiguous and 16-byte aligned (C a multiple of 32);
// w [C, 1, 31] float32, contiguous; offsets [B + 1] int32, clip b's rows
// offsets[b] .. offsets[b + 1] - 1 (offsets[0] = 0, offsets[B] = R); y [R, C]
// float32, contiguous.
extern "C" int glu_depthwise_launch(const void* x, const void* w, const void* offsets, void* y,
                                    int R, int C, int B, void* stream) {
  if (R < 1 || B < 1 || C < CH || C % CH) return (int)cudaErrorInvalidValue;
  glu_depthwise_kernel<<<dim3((R + ROWS - 1) / ROWS, C / CH), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const int*)offsets, (float*)y, R, C, B);
  return (int)cudaGetLastError();
}

// x [R, 2 C] float32, contiguous and 16-byte aligned (C a multiple of 32);
// w [C, 9] float32, contiguous (the folded taps); bias [C] float32;
// offsets [B + 1] int32 as glu_depthwise_launch's; y [R, C] float32,
// contiguous.
extern "C" int glu_conv_silu_launch(const void* x, const void* w, const void* bias,
                                    const void* offsets, void* y, int R, int C, int B,
                                    void* stream) {
  if (R < 1 || B < 1 || C < CH || C % CH) return (int)cudaErrorInvalidValue;
  glu_conv_silu_kernel<<<dim3((R + ROWS - 1) / ROWS, C / CH), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const float*)bias, (const int*)offsets, (float*)y, R, C,
      B);
  return (int)cudaGetLastError();
}
