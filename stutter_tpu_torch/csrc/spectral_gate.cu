// Non-stationary spectral gate (noisereduce-equivalent) for Hopper (sm_90a), FP32.
//
// Replaces stutter_tpu/ops/pallas_denoise.py:spectral_gate_pallas (bodies
// _gate_kernel, _affine_scan).  Hop-chunked padded audio [B, C, hop] ->
// overlap-added output [B, T + 3, hop] (T = C - 3 frames, K = n_fft/2 + 1
// bins, n_fft = 4 hop in {512, 1024, 2048}), in three launches:
//
//  1. gate_analysis<M>, one block per (clip, tile of F frames): stages the
//     tile's audio span (frames overlap 4x) in shared memory with cp.async,
//     applies the periodic Hann in time, runs each frame's real FFT in
//     shared memory (rfft_smem.cuh) and writes |Y| [B, T, K].
//  2. gate_iir_mask, one block per (clip, tile of KB bins): stages the
//     [T, KB] column tile of |Y| in shared memory with coalesced loads and
//     runs noisereduce's filtfilt([b], [1, b-1]) with steady-state starts,
//     forward then backward over T, as a chunked scan: 256 / KB threads per
//     bin each scan a segment of time, then the segments' carries are
//     chained and added back (y = local + a^n carry).  The sigmoid mask
//     sigmoid(((|Y| - s) / s - thresh) * slope), 0 where s == 0, replaces
//     |Y| in shared memory, and the mask smoother's time taps (zero 'same'
//     padding) run down the whole column there; written to [B, T, K].
//  3. gate_synth<M>, one block per (clip, tile of TT output hop-rows): loads
//     the time-smoothed mask rows of frames r0 - 3 .. r0 + TT - 1 with a
//     +-kf/2-bin zero halo, applies the frequency taps (4 outputs a thread
//     from a sliding register window over rows kept in 4 bank planes) and
//     blends prop_decrease; recomputes those frames' spectra by FFT from the
//     audio instead of storing them; multiplies, runs the inverse real FFT,
//     applies the synthesis Hann and 1/n_fft; overlap-adds inside the block
//     as a gather -- row r is the sum over slots s < 4 of slot s of frame
//     r - s, s in ascending order, no atomics, deterministic -- and
//     multiplies by the reciprocal window-sum-square.  The separable
//     smoothing runs time-then-frequency where the plain version runs
//     frequency-then-time: the same sums in another rounding order.
//
// Bounds on an H100: the FFTs are ~5 n log2 n / 2 FLOP a frame (3 a frame
// with the recomputation) and the smoothing 2 (kf + kt) a bin, so the work
// is bound by moving bytes: the audio in, |Y| out and back in, the mask out
// and back in, the output out.  The dense DFT / IDFT GEMMs this design
// replaces were FP32-issue-bound at ~1 GFLOP per 3 s clip; the old yr / yi
// scratch is gone.  Launch 2 is a dependency chain over T; the chunked scan
// cuts it to ~T / (256 / KB) steps a thread, out of shared memory.
#include "rfft_smem.cuh"

using namespace rfft;

namespace {

constexpr int RATIO = 4;      // n_fft / hop: the gate's only geometry
constexpr int MAX_TAPS = 128;  // per axis of the mask smoother

template <int M>
__global__ void __launch_bounds__(THREADS)
    gate_analysis(const float* __restrict__ sig, int C, int T, int hop, int F,
                  const float* __restrict__ win, const float2* __restrict__ tw,
                  float* __restrict__ mag) {
  constexpr int K = M + 1, MP = frame_stride<M>();
  extern __shared__ __align__(16) float smem[];
  float2* buf = reinterpret_cast<float2*>(smem);  // [F * MP] frames
  float* span = smem + 2 * F * MP;                // [(F - 1) * hop + 2M] audio
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * F;
  const int tf = min(F, T - t0);

  stage_span(span, sig + (size_t)b * C * hop, (long)t0 * hop, (tf - 1) * hop + 2 * M,
             (long)C * hop);
  fft_windowed<M>(buf, tf, tw, span, hop, win);
  float* out = mag + ((size_t)b * T + t0) * K;
  for (int i = threadIdx.x; i < tf * K; i += THREADS) {
    const int f = i / K, k = i - f * K;
    const float2* z = buf + f * MP;
    const float2 x = split(z[padded(k & (M - 1))], z[padded((M - k) & (M - 1))], __ldg(tw + k));
    out[i] = sqrtf(x.x * x.x + x.y * x.y);
  }
}

// The IIR, the sigmoid mask and the mask smoother's time taps (zero 'same'
// padding), for a [T, KB] column tile; writes the time-smoothed mask.
__global__ void __launch_bounds__(THREADS)
    gate_iir_mask(const float* __restrict__ mag, float* __restrict__ mk, int T, int K, int KB,
                  float bb, float a, float thresh, float slope,
                  const float* __restrict__ t_taps, int kt) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float ts[MAX_TAPS];
  const int S = THREADS / KB;  // time segments per bin
  float* X = smem;             // [T * KB] |Y|, later the mask
  float* Y = X + T * KB;       // [T * KB] forward, then backward, local results
  float* L = Y + T * KB;       // [S * KB] a segment's local end value
  float* P = L + S * KB;       // [S * KB] the product of its coefficients
  float* Cin = P + S * KB;     // [S * KB] the true value entering it
  const int b = blockIdx.y;
  const int k0 = blockIdx.x * KB;
  const int kb = min(KB, K - k0);
  const size_t base = (size_t)b * T * K + k0;

  if (threadIdx.x < kt) ts[threadIdx.x] = t_taps[threadIdx.x];
  for (int i = threadIdx.x; i < T * KB; i += THREADS) {
    const int t = i / KB, c = i - t * KB;
    cp_async4(X + i, mag + base + (size_t)t * K + (c < kb ? c : 0), c < kb);
  }
  cp_async_wait();

  const int c = threadIdx.x % KB, s = threadIdx.x / KB;
  const int len = (T + S - 1) / S;
  const int ts0 = min(s * len, T), te = min(ts0 + len, T);

  // forward: y[0] = x[0], y[t] = a y[t-1] + bb x[t] -- coefficient a_t (0
  // at t = 0) and input u_t; local scan from 0, then y = local + (prod a) carry
  float y = 0.f, p = 1.f;
  for (int t = ts0; t < te; ++t) {
    const float x = X[t * KB + c];
    y = t == 0 ? x : a * y + bb * x;
    p = t == 0 ? 0.f : p * a;
    Y[t * KB + c] = y;
  }
  L[s * KB + c] = y;
  P[s * KB + c] = p;
  __syncthreads();
  if (s == 0) {
    float carry = 0.f;
    for (int j = 0; j < S; ++j) {
      Cin[j * KB + c] = carry;
      carry = L[j * KB + c] + P[j * KB + c] * carry;
    }
  }
  __syncthreads();
  float carry = Cin[s * KB + c], q = 1.f;
  for (int t = ts0; t < te; ++t) {
    q = t == 0 ? 0.f : q * a;
    Y[t * KB + c] += q * carry;
  }
  __syncthreads();

  // backward over the forward pass: z[T-1] = f[T-1], z[t] = a z[t+1] + bb f[t]
  y = 0.f;
  p = 1.f;
  for (int t = te - 1; t >= ts0; --t) {
    const float f = Y[t * KB + c];
    y = t == T - 1 ? f : a * y + bb * f;
    p = t == T - 1 ? 0.f : p * a;
    Y[t * KB + c] = y;
  }
  L[s * KB + c] = y;
  P[s * KB + c] = p;
  __syncthreads();
  if (s == 0) {
    float cin = 0.f;
    for (int j = S - 1; j >= 0; --j) {
      Cin[j * KB + c] = cin;
      cin = L[j * KB + c] + P[j * KB + c] * cin;
    }
  }
  __syncthreads();
  carry = Cin[s * KB + c];
  q = 1.f;
  for (int t = te - 1; t >= ts0; --t) {
    q = t == T - 1 ? 0.f : q * a;
    const float z = Y[t * KB + c] + q * carry;
    const float x = X[t * KB + c];
    const float above = z > 0.f ? (x - z) / z : 0.f;
    X[t * KB + c] = 1.f / (1.f + expf(-((above - thresh) * slope)));
  }
  __syncthreads();

  const int pt = kt / 2;
  for (int i = threadIdx.x; i < T * KB; i += THREADS) {
    const int t = i / KB, cc = i - t * KB;
    float acc = 0.f;
    for (int j = 0; j < kt; ++j) {
      const int u = t + j - pt;
      if (u >= 0 && u < T) acc += ts[j] * X[u * KB + cc];
    }
    if (cc < kb) mk[base + (size_t)t * K + cc] = acc;
  }
}

// Shared memory of gate_synth, in floats: the FFT region (the frames and the
// audio span) aliased with the mask rows and their frequency halo, then the
// smoothed mask.  The span ends where the frames end when it fits inside the
// last FFT group's frames: the groups before never write there, and the
// last group reads all of it in its first pass before it writes (a third
// less shared memory: two blocks an SM at 16 frames of 512).  A mask row
// keeps its columns in 4 planes (column c at (c mod 4) * planes + c / 4), so
// that threads sliding 4-wide windows along a row read distinct banks.
struct SynthLayout {
  int planes, row, frames, span_end, region, mf;
  __host__ __device__ SynthLayout(int M, int TT, int hop, int kf) {
    const int K = M + 1, nf = TT + RATIO - 1, fs = 2 * (M + M / 16);
    planes = (K + kf + 6 + 3) / 4;  // the last window reads up to column K + kf + 5
    row = 4 * planes;
    frames = nf * fs;
    const int span = (nf - 1) * hop + 2 * M;
    const int last_group = (TILE_POINTS / M) * ((nf - 1) / (TILE_POINTS / M));
    span_end = span <= (nf - last_group) * fs ? frames : frames + span;
    region = nf * row > span_end ? nf * row : span_end;
    mf = nf * K;
  }
  __host__ __device__ size_t bytes() const { return sizeof(float) * ((size_t)region + mf); }
};

template <int M>
__global__ void __launch_bounds__(THREADS)
    gate_synth(const float* __restrict__ sig, int C, int T, int hop, int TT,
               const float* __restrict__ win, const float2* __restrict__ tw,
               const float* __restrict__ mk, const float* __restrict__ f_taps, int kf,
               float prop, const float* __restrict__ winv, float* __restrict__ out) {
  constexpr int K = M + 1, N = 2 * M, MP = frame_stride<M>();
  extern __shared__ __align__(16) float smem[];
  __shared__ float fs[MAX_TAPS];
  const SynthLayout lay(M, TT, hop, kf);
  float* A = smem;                                // [nf * row] mask rows with halo, in planes
  float2* buf = reinterpret_cast<float2*>(smem);  // [nf * MP] frames (aliases A)
  float* Mf = smem + lay.region;                  // [nf * K] the blended mask
  const int b = blockIdx.y;
  const int n_rows = T + RATIO - 1;
  const int r0 = blockIdx.x * TT;
  const int fa = max(r0 - (RATIO - 1), 0), fb = min(r0 + TT, T);
  const int nf = fb - fa;
  const int pf = kf / 2;

  if (threadIdx.x < kf) fs[threadIdx.x] = f_taps[threadIdx.x];
  for (int i = threadIdx.x; i < nf * lay.row; i += THREADS) {
    const int r = i / lay.row, c = i - r * lay.row, k = c - pf;
    const bool ok = k >= 0 && k < K;
    cp_async4(A + r * lay.row + (c & 3) * lay.planes + (c >> 2),
              mk + ((size_t)b * T + fa + r) * K + (ok ? k : 0), ok);
  }
  cp_async_wait();
  // frequency taps over 4 outputs a thread, from a sliding window
  constexpr int G4 = (K + 3) / 4;
  for (int i = threadIdx.x; i < nf * G4; i += THREADS) {
    const int f = i / G4, k0 = (i - f * G4) * 4;
    const float* row = A + f * lay.row;
    const int pl = lay.planes;
    auto at = [row, pl](int c) { return row[(c & 3) * pl + (c >> 2)]; };
    float w0 = at(k0), w1 = at(k0 + 1), w2 = at(k0 + 2), w3 = at(k0 + 3);
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    for (int j = 0; j < kf; ++j) {
      const float t = fs[j];
      a0 += t * w0;
      a1 += t * w1;
      a2 += t * w2;
      a3 += t * w3;
      w0 = w1;
      w1 = w2;
      w2 = w3;
      w3 = at(k0 + 4 + j);
    }
    float* m = Mf + f * K + k0;
    m[0] = a0 * prop + (1.f - prop);
    if (k0 + 1 < K) m[1] = a1 * prop + (1.f - prop);
    if (k0 + 2 < K) m[2] = a2 * prop + (1.f - prop);
    if (k0 + 3 < K) m[3] = a3 * prop + (1.f - prop);
  }
  __syncthreads();

  // the frames' spectra again, from the audio
  const int span_len = (nf - 1) * hop + N;
  float* span = smem + lay.span_end - span_len;
  stage_span(span, sig + (size_t)b * C * hop, (long)fa * hop, span_len, (long)C * hop);
  fft_windowed<M>(buf, nf, tw, span, hop, win);

  // per bin pair (p, M - p): split, mask, undo the split, conjugate
  constexpr int PAIRS = M / 2 + 1;
  for (int i = threadIdx.x; i < nf * PAIRS; i += THREADS) {
    const int f = i / PAIRS, p = i - f * PAIRS, q = M - p;
    float2* z = buf + f * MP;
    const float* m = Mf + f * K;
    const float2 za = z[padded(p)], zb = z[padded(q & (M - 1))];
    const float2 wp = __ldg(tw + p), wq = __ldg(tw + q);
    float2 yp = split(za, zb, wp), yq = split(zb, za, wq);
    yp = make_float2(yp.x * m[p], yp.y * m[p]);
    yq = make_float2(yq.x * m[q], yq.y * m[q]);
    z[padded(p)] = unsplit_conj(yp, yq, wp);
    if (p > 0 && q != p) z[padded(q)] = unsplit_conj(yq, yp, wq);
  }
  __syncthreads();
  fft<M>(buf, nf, tw);
  const float scale = 1.f / N;
  const float2* w2 = reinterpret_cast<const float2*>(win);
  for (int i = threadIdx.x; i < nf * M; i += THREADS) {
    const int f = i / M, m = i - f * M;
    float2* z = buf + f * MP + padded(m);
    const float2 g = *z, w = __ldg(w2 + m);
    *z = make_float2(g.x * scale * w.x, -g.y * scale * w.y);
  }
  __syncthreads();

  // overlap-add as a gather: sample n of frame f is component n % 2 of
  // point n / 2 of its buffer frame
  const float* xs = reinterpret_cast<const float*>(buf);
  const int rt = min(TT, n_rows - r0);
#pragma unroll 4
  for (int i = threadIdx.x; i < rt * hop; i += THREADS) {
    const int r = r0 + i / hop, j = i % hop;
    float acc = 0.f;
#pragma unroll
    for (int s = 0; s < RATIO; ++s) {
      const int f = r - s, n = s * hop + j;
      if (f >= 0 && f < T) acc += xs[2 * ((f - fa) * MP + padded(n >> 1)) + (n & 1)];
    }
    out[((size_t)b * n_rows + r) * hop + j] = acc * winv[(size_t)r * hop + j];
  }
}

template <int M>
cudaError_t launch_gate(const float* sig, const float* win, const float2* tw,
                        const float* f_taps, const float* t_taps, const float* winv,
                        float* mag, float* mk, float* out, int B, int C, int hop, int kf, int kt,
                        int F, int KB, int TT, float bb, float a, float thresh, float slope,
                        float prop, cudaStream_t s) {
  const int T = C - RATIO + 1;
  const size_t smem1 =
      sizeof(float) * ((size_t)2 * F * frame_stride<M>() + (F - 1) * hop + 2 * M);
  const size_t smem2 = sizeof(float) * ((size_t)2 * T * KB + 3 * THREADS);
  const SynthLayout lay(M, TT, hop, kf);
  if (F < 1 || F * M > TILE_POINTS || TT < 1 || smem1 > MAX_SMEM || smem2 > MAX_SMEM ||
      lay.bytes() > MAX_SMEM)
    return cudaErrorInvalidValue;

  cudaError_t err = cudaFuncSetAttribute(gate_analysis<M>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return err;
  gate_analysis<M><<<dim3((T + F - 1) / F, B), THREADS, smem1, s>>>(sig, C, T, hop, F, win, tw,
                                                                    mag);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  err = cudaFuncSetAttribute(gate_iir_mask, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return err;
  gate_iir_mask<<<dim3((M + 1 + KB - 1) / KB, B), THREADS, smem2, s>>>(
      mag, mk, T, M + 1, KB, bb, a, thresh, slope, t_taps, kt);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  err = cudaFuncSetAttribute(gate_synth<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)lay.bytes());
  if (err != cudaSuccess) return err;
  const int n_rows = T + RATIO - 1;
  gate_synth<M><<<dim3((n_rows + TT - 1) / TT, B), THREADS, lay.bytes(), s>>>(
      sig, C, T, hop, TT, win, tw, mk, f_taps, kf, prop, winv, out);
  return cudaGetLastError();
}

}  // namespace

// F: frames per analysis tile; KB: bins per IIR tile (a power of two <= 32);
// TT: output hop-rows per synthesis tile.
extern "C" int spectral_gate_launch(const void* chunks, const void* win, const void* tw,
                                    const void* f_taps, const void* t_taps, const void* winv,
                                    void* mag, void* mk, void* out, int B, int C, int n_fft,
                                    int hop, int kf, int kt, int F, int KB, int TT, float bb,
                                    float a, float thresh, float slope, float prop, void* stream) {
  if (n_fft != RATIO * hop || C < RATIO || kf < 1 || kt < 1 || kf > MAX_TAPS || kt > MAX_TAPS ||
      KB < 2 || KB > 32 || (KB & (KB - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  decltype(&launch_gate<512>) launch = nullptr;
  if (n_fft == 512) launch = &launch_gate<256>;
  if (n_fft == 1024) launch = &launch_gate<512>;
  if (n_fft == 2048) launch = &launch_gate<1024>;
  if (launch == nullptr) return (int)cudaErrorInvalidValue;
  return (int)launch((const float*)chunks, (const float*)win, (const float2*)tw,
                     (const float*)f_taps, (const float*)t_taps, (const float*)winv, (float*)mag,
                     (float*)mk, (float*)out, B, C, hop, kf, kt, F, KB, TT, bb, a, thresh, slope,
                     prop, s);
}
