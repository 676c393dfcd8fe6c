// Per-frame real FFT in shared memory for Hopper (sm_90a), FP32; used by
// spectromel.cu and spectral_gate.cu.
//
// An n_fft-point real FFT (n_fft = 2M, M in {256, 512, 1024}) is an M-point
// complex FFT of z[m] = x[2m] + i x[2m+1] followed by the real split
//   X[k] = ((Z[k] + conj Z[M-k]) + w^k (Z[k] - conj Z[M-k]) / i) / 2,
// w = e^{-2 pi i / n_fft}, k = 0..M (indices of Z mod M).  The complex FFT
// is a Stockham autosort FFT: radix-4 passes at strides 1, 4, 16, ..., then
// one radix-2 pass when log2 M is odd.  Pass j of a radix-r butterfly at
// stride ns reads r points M / r apart, twiddles them by w_M^{(j mod ns) k
// M / (r ns)}, and writes them ns apart from (j / ns) r ns + j mod ns.  A
// block keeps its F frames of M points in one buffer and transforms them
// TILE_POINTS / M frames at a time: each pass reads its butterflies into
// registers, synchronises, writes back in place and synchronises again, so
// no second buffer is needed.  The inverse transform (the gate's iSTFT)
// undoes the split (`unsplit_conj`), runs the same forward FFT on the
// conjugate and conjugates back.
//
// The twiddles w^s, s < n_fft, are a float64 table rounded to f32
// (ops/consts.py:rfft_twiddles), uploaded once per device and read through
// the read-only cache.  tests/test_torch_fft.py runs this stage order in
// NumPy with the same table against np.fft.rfft / irfft.
//
// Bounds on an H100: a 2048-point frame costs ~5 n log2 n / 2 = 56 kFLOP
// and 8 KB of shared memory, against the ~2 n^2 = 8.4 MFLOP of the dense
// DFT GEMM this replaces; what limits these kernels is moving the audio in
// and the spectra out of device memory, and the shared-memory traffic of
// the passes (2 x 8 bytes per point per pass).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace rfft {

constexpr int THREADS = 256;       // threads of every block that runs these helpers
constexpr int TILE_POINTS = 4096;  // complex points of a block's FFT buffer
constexpr int MAX_SMEM = 232448;   // bytes of shared memory a block can have

__device__ inline float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Frames sit in the buffer with one float2 of padding after every 16
// points, so that the strided writes of the radix-16 passes fall in
// distinct banks: point m of frame f is at buf[f * frame_stride<M>() + padded(m)].
__host__ __device__ constexpr int padded(int m) { return m + (m >> 4); }
template <int M>
__host__ __device__ constexpr int frame_stride() { return M + M / 16; }

// In-place forward DFTs of R points in registers, natural order in and out.
__device__ inline void dft2(float2* v) {
  const float2 a = v[0], b = v[1];
  v[0] = make_float2(a.x + b.x, a.y + b.y);
  v[1] = make_float2(a.x - b.x, a.y - b.y);
}

__device__ inline void dft4(float2* v) {
  const float2 a0 = make_float2(v[0].x + v[2].x, v[0].y + v[2].y);
  const float2 a1 = make_float2(v[0].x - v[2].x, v[0].y - v[2].y);
  const float2 a2 = make_float2(v[1].x + v[3].x, v[1].y + v[3].y);
  const float2 a3 = make_float2(v[1].y - v[3].y, v[3].x - v[1].x);  // -i (v1 - v3)
  v[0] = make_float2(a0.x + a2.x, a0.y + a2.y);
  v[1] = make_float2(a1.x + a3.x, a1.y + a3.y);
  v[2] = make_float2(a0.x - a2.x, a0.y - a2.y);
  v[3] = make_float2(a1.x - a3.x, a1.y - a3.y);
}

// 16 = 4 x 4: DFT4 over n1 for each n2 (n = 4 n1 + n2), twiddle by
// w16^{n2 k1}, DFT4 over n2 for each k1; out[k1 + 4 k2].
__device__ inline void dft16(float2* v) {
  constexpr float C1 = 0.923879532511286756f, S1 = 0.382683432365089772f,
                  H = 0.707106781186547524f;
  // w16^e for e = n2 * k1, n2, k1 in 1..3
  const float2 w[3][3] = {{{C1, -S1}, {H, -H}, {S1, -C1}},
                          {{H, -H}, {0.f, -1.f}, {-H, -H}},
                          {{S1, -C1}, {-H, -H}, {-C1, S1}}};
  float2 a[4][4];
#pragma unroll
  for (int n2 = 0; n2 < 4; ++n2) {
    float2 t[4] = {v[n2], v[4 + n2], v[8 + n2], v[12 + n2]};
    dft4(t);
#pragma unroll
    for (int k1 = 0; k1 < 4; ++k1)
      a[n2][k1] = (n2 && k1) ? cmul(t[k1], w[n2 - 1][k1 - 1]) : t[k1];
  }
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1) {
    float2 t[4] = {a[0][k1], a[1][k1], a[2][k1], a[3][k1]};
    dft4(t);
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2) v[k1 + 4 * k2] = t[k2];
  }
}

template <int R>
__device__ inline void dft(float2* v) {
  if constexpr (R == 16) dft16(v);
  else if constexpr (R == 4) dft4(v);
  else dft2(v);
}

// One Stockham pass of radix R at stride NS over F frames: butterfly j reads
// the R points j + r M / R (through `load(f, m)`), twiddles point r by
// w_M^{(j mod NS) r M / (R NS)}, transforms, and writes point r to
// (j / NS) R NS + j mod NS + r NS.  The radix-16 pass at stride 16 takes its
// twiddles from tw16[r * 16 + j mod 16] in shared memory (its 15 loads a
// butterfly would otherwise scatter over the table); the last pass reads the
// table, where neighbouring butterflies read neighbouring twiddles.
template <int M, int R, int NS, typename Load>
__device__ inline void pass(float2* buf, int F, const float2* __restrict__ tw,
                            const float2* tw16, Load load) {
  constexpr int Q = M / R, MP = frame_stride<M>();
  constexpr int PER = TILE_POINTS / R / THREADS;  // butterflies a thread holds
  const int items = F * Q;
  float2 v[PER][R];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = threadIdx.x + u * THREADS;
    if (i < items) {
      const int f = i / Q, j = i - f * Q;
#pragma unroll
      for (int r = 0; r < R; ++r) v[u][r] = load(f, j + r * Q);
      if constexpr (R == 16 && NS == 16) {
#pragma unroll
        for (int r = 1; r < R; ++r) v[u][r] = cmul(v[u][r], tw16[r * 16 + (j & 15)]);
      } else if constexpr (NS > 1) {
        const int step = 2 * (j % NS) * (M / (R * NS));  // in units of w = w_M^{1/2}
#pragma unroll
        for (int r = 1; r < R; ++r) v[u][r] = cmul(v[u][r], __ldg(tw + r * step));
      }
      dft<R>(v[u]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = threadIdx.x + u * THREADS;
    if (i < items) {
      const int f = i / Q, j = i - f * Q;
      float2* out = buf + f * MP;
      const int d = (j / NS) * NS * R + j % NS;
#pragma unroll
      for (int r = 0; r < R; ++r) out[padded(d + r * NS)] = v[u][r];
    }
  }
  __syncthreads();
}

// Radix 16 while it fits, then 4, then 2: M = 256 -> 16 16; 512 -> 16 16 2;
// 1024 -> 16 16 4.  The first pass reads through `load`.
template <int M, int NS, typename Load>
__device__ inline void passes(float2* buf, int F, const float2* __restrict__ tw,
                              const float2* tw16, Load load) {
  constexpr int MP = frame_stride<M>();
  auto from_buf = [buf](int f, int m) { return buf[f * MP + padded(m)]; };
  if constexpr (NS * 16 <= M) {
    pass<M, 16, NS>(buf, F, tw, tw16, load);
    passes<M, NS * 16>(buf, F, tw, tw16, from_buf);
  } else if constexpr (NS * 4 <= M) {
    pass<M, 4, NS>(buf, F, tw, tw16, load);
    passes<M, NS * 4>(buf, F, tw, tw16, from_buf);
  } else if constexpr (NS < M) {
    pass<M, 2, NS>(buf, F, tw, tw16, load);
  }
}

// Forward M-point FFT, in place in the buffer, of F frames whose input
// point m of frame f is load(f, m), in groups of TILE_POINTS / M frames (a
// thread holds at most TILE_POINTS / THREADS points of a pass; a pass never
// leaves its frame, so the groups are independent).  Every thread of the
// block calls it; it ends synchronised.
template <int M, typename Load>
__device__ inline void fft(float2* buf, int F, const float2* __restrict__ tw, Load load) {
  static_assert(M >= 256 && (M & (M - 1)) == 0, "M must be a power of two >= 256");
  constexpr int G = TILE_POINTS / M, MP = frame_stride<M>();
  __shared__ float2 tw16[256];  // w_M^{(j mod 16) r M / 256} at r * 16 + j mod 16
  for (int i = threadIdx.x; i < 256; i += THREADS)
    tw16[i] = __ldg(tw + 2 * (i & 15) * (i >> 4) * (M / 256));
  __syncthreads();
  for (int g = 0; g < F; g += G) {
    auto at = [&load, g](int f, int m) { return load(g + f, m); };
    passes<M, 1>(buf + g * MP, min(G, F - g), tw, tw16, at);
  }
}

// The FFT of the buffer's own frames.
template <int M>
__device__ inline void fft(float2* buf, int F, const float2* __restrict__ tw) {
  constexpr int MP = frame_stride<M>();
  fft<M>(buf, F, tw, [buf](int f, int m) { return buf[f * MP + padded(m)]; });
}

// The FFT of F windowed frames of the staged audio: frame f starts at
// span + f * hop (hop even, span 8-byte aligned), and its point m is
// (x[2m] win[2m], x[2m+1] win[2m+1]).
template <int M>
__device__ inline void fft_windowed(float2* buf, int F, const float2* __restrict__ tw,
                                    const float* span, int hop, const float* __restrict__ win) {
  const float2* s2 = reinterpret_cast<const float2*>(span);
  const float2* w2 = reinterpret_cast<const float2*>(win);
  fft<M>(buf, F, tw, [s2, hop, w2](int f, int m) {
    const float2 x = s2[f * (hop / 2) + m], w = __ldg(w2 + m);
    return make_float2(x.x * w.x, x.y * w.y);
  });
}

// X[k] of the real frame from a = Z[k mod M], b = Z[(M - k) mod M], w = w^k.
__device__ inline float2 split(float2 a, float2 b, float2 w) {
  const float er = a.x + b.x, ei = a.y - b.y;  // a + conj b
  const float orr = a.y + b.y, oi = b.x - a.x;  // (a - conj b) / i
  return make_float2(0.5f * (er + w.x * orr - w.y * oi), 0.5f * (ei + w.x * oi + w.y * orr));
}

// The inverse of `split`, times 2 and conjugated: conj(2 Z'[k]) with
// Z'[k] = E + i O, E = (Y[k] + conj Y[M-k]) / 2, O = (Y[k] - conj Y[M-k]) w^-k / 2,
// from ya = Y[k], yb = Y[M - k], w = w^k.  A forward FFT of these values,
// conjugated and divided by n_fft, is irfft(Y) with its samples in pairs.
__device__ inline float2 unsplit_conj(float2 ya, float2 yb, float2 w) {
  const float er = ya.x + yb.x, ei = ya.y - yb.y;
  const float dr = ya.x - yb.x, di = ya.y + yb.y;
  const float orr = dr * w.x + di * w.y, oi = di * w.x - dr * w.y;  // D conj(w)
  return make_float2(er - oi, -(ei + orr));
}

// *dst = *src by an asynchronous 4-byte copy, or 0 when !ok (src is then
// not read).  Many copies stay in flight; cp_async_wait ends them.
__device__ inline void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 4 : 0));
}

// Waits for this thread's copies, then synchronises the block.
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// dst[i] = sig[start + i] for i < len, 0 where start + i is outside [0, n);
// the block synchronises.
__device__ inline void stage_span(float* dst, const float* __restrict__ sig, long start, int len,
                                  long n) {
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const long pos = start + i;
    const bool ok = pos >= 0 && pos < n;
    cp_async4(dst + i, ok ? sig + pos : sig, ok);
  }
  cp_async_wait();
}

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ inline float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace rfft
