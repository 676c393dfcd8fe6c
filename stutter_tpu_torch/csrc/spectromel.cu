// Fused spectromel kernel for Hopper (sm_90a), FP32.
//
// Replaces stutter_tpu/ops/pallas_spectromel.py:spectromel_pallas with
// with_tuning=True (body _spectromel_kernel, _candidates_of, _mfcc_stats_of)
// in both of its output modes, at n_fft 512, 1024 or 2048 and any even hop
// that divides the bucket:
//
//  * stats mode (with_stats=True; the 149-dim front end): power [B, T, K],
//    MFCC/delta statistics [B, 6, n_mfcc], tuning bin [B]; launches 1-3
//    below (`spectromel_launch`).
//  * mel-output mode (with_stats=False; the 286-dim variant at n_fft 512,
//    hop 256, through ops/frontend.py:spect_mel_db): power [B, T, K], the
//    linear mel spectrum [B, T, M] and the tuning bin [B]; launches 1 and 3
//    (`spectromel_mel_launch`).  The variant reduces the mel spectrum in
//    plain PyTorch (ops/frontend334.py) as the JAX package does in XLA.
//
//  1. spectromel_frames<M>, one block per (clip, tile of F frames; F
//     follows B x T so that a single request still spreads over the SMs):
//     stages the tile's audio span in shared memory with cp.async (frames
//     overlap n_fft / hop times), applies the periodic Hann in time, runs
//     each frame's real FFT in shared memory (rfft_smem.cuh), and from the
//     same values computes |.|^2 under the frame mask, written once as power
//     (the chroma kernel reads it), each frame's max, the piptrack
//     candidates of the 150-4000 Hz band in the port's uncompacted layout
//     (mags, residual bin as f32 or -1), and the mel spectrum as a sum over
//     each band's nonzero bin range (a host table [start, length, offset]
//     plus the weights, which rebuilds mel_fb exactly; ops/consts.py) --
//     in stats mode already in dB (10 log10 max(mel, 1e-10)), once a value.
//  2. spectromel_stats (stats mode only), one block per clip: librosa
//     power_to_db's 80 dB clamp under the max over valid frames, the
//     orthonormal DCT-II, SavGol delta and delta-delta (width 9; interior
//     taps, static first edge, last edge at the clip's own n_valid), and the
//     masked mean and population std -> stats [B, 6, n_mfcc].
//  3. tuning_tail, one block per clip: the tuning bin from the candidates,
//     as ops/chroma.py:tuning_bin_from_candidates (XLA in the JAX package,
//     stutter_tpu/ops/chroma.py:213) computes it -- the exact median of the
//     candidate magnitudes by radix selection on order-preserving u32 keys,
//     then the first maximum of the 100-bin histogram of the candidates at
//     or above it (integer shared-memory counts, so exact), bin 50 when
//     there is no candidate.
//
// Bounds on an H100: launch 1 reads the audio once (from shared memory
// n_fft / hop times) and writes power, mel and the two candidate arrays;
// its FFTs are ~5 n log2 n / 2 FLOP a frame, far below the FP32 rate, so
// the launch is bound by those bytes, which the dense chunk-DFT GEMM of the
// earlier design (FP32-issue-bound, ~0.2 GFLOP per 3 s clip) and its chunk
// scratch are no longer in the way of.  A clip's power (97 x 1025 f32 at
// 3 s) does not fit one SM's shared memory, hence frame tiles, the mel
// written for launch 2, and the per-clip stats launch.
//
// The candidate arithmetic uses __f*_rn intrinsics, which the compiler never
// fuses into FMAs: every operation rounds as the plain PyTorch version's
// separate elementwise ops do, so the tuning bin computed from the kernel's
// own power matches the plain estimate on that power exactly.
#include "rfft_smem.cuh"

using namespace rfft;

namespace {

constexpr float F32_TINY = 1.17549435e-38f;
constexpr int WIDTH = 9;  // SavGol window
constexpr int HALF = WIDTH / 2;
constexpr int SG_ROWS = 1 + 2 * HALF;  // interior taps, first rows, last rows

// One piptrack candidate at bin k of power row P (see ops/chroma.py,
// piptrack_candidates: same operations, same order).
__device__ inline void candidate_at(const float* P, int k, float fmax, float rb, float c_ln2,
                                    float& mag, float& idx) {
  const float ref = __fmul_rn(0.1f, fmax);
  const float sb = P[k], hm = P[k - 1], hp = P[k + 1];
  const float g = sb > ref ? sb : 0.f;
  const float gm = hm > ref ? hm : 0.f;
  const float gp = hp > ref ? hp : 0.f;
  mag = 0.f;
  idx = -1.f;
  if (!((g > gm) && (g >= gp))) return;  // not a local maximum: no division needed
  const float avg = __fmul_rn(0.5f, __fsub_rn(hp, hm));
  const float den = __fsub_rn(__fsub_rn(__fmul_rn(2.0f, sb), hp), hm);
  const float shift = __fdiv_rn(avg, __fadd_rn(den, fabsf(den) < F32_TINY ? 1.0f : 0.0f));
  const float dskew = __fmul_rn(__fmul_rn(0.5f, avg), shift);
  const float binf = (float)k;
  if (!(__fadd_rn(binf, shift) > 0.f)) return;
  const float u = __fdiv_rn(shift, fmaxf(binf, 1.0f));
  float p = __fmul_rn(u, (float)(-1.0 / 8));
  p = __fmul_rn(u, __fadd_rn((float)(1.0 / 7), p));
  p = __fmul_rn(u, __fadd_rn((float)(-1.0 / 6), p));
  p = __fmul_rn(u, __fadd_rn((float)(1.0 / 5), p));
  p = __fmul_rn(u, __fadd_rn((float)(-1.0 / 4), p));
  p = __fmul_rn(u, __fadd_rn((float)(1.0 / 3), p));
  p = __fmul_rn(u, __fadd_rn((float)(-1.0 / 2), p));
  p = __fmul_rn(u, __fadd_rn(1.0f, p));
  float r = fmodf(__fadd_rn(rb, __fmul_rn(c_ln2, p)), 1.0f);
  if (r < 0.f) r = __fadd_rn(r, 1.0f);
  if (r >= 0.5f) r = __fsub_rn(r, 1.0f);
  const float bin = floorf(__fmul_rn(__fadd_rn(r, 0.5f), 100.0f));
  mag = __fadd_rn(sb, dskew);
  idx = fminf(fmaxf(bin, 0.f), 99.f);
}

__device__ inline float db_of(float x) { return 10.0f * log10f(fmaxf(x, 1e-10f)); }

// One block per (clip, tile of F frames): power, mel (in dB when `db`: the
// stats mode's only use of it) and candidates.
template <int M>
__global__ void __launch_bounds__(THREADS)
    spectromel_frames(const float* __restrict__ audio, const int* __restrict__ lengths, int N,
                      int T, int hop, int F, const float* __restrict__ win,
                      const float2* __restrict__ tw, const int* __restrict__ mel_ranges,
                      const float* __restrict__ mel_w, int n_mels,
                      const float* __restrict__ rtab, int lo, int hi, float c_ln2, int db,
                      float* __restrict__ power, float* __restrict__ mel,
                      float* __restrict__ mags, float* __restrict__ idxm) {
  constexpr int K = M + 1, NFFT = 2 * M, MP = frame_stride<M>();
  extern __shared__ __align__(16) float smem[];
  float2* buf = reinterpret_cast<float2*>(smem);  // [F * MP] frames
  float* span = smem + 2 * F * MP;                // [(F - 1) * hop + n_fft] audio, 8-byte aligned
  float* P = span + (F - 1) * hop + NFFT;         // [F * K] the tile's power
  __shared__ float fmax_s[TILE_POINTS / 256];

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * F;
  const int tf = min(F, T - t0);
  const int nv = 1 + lengths[b] / hop;

  // centred frames: frame t starts at sample t * hop - n_fft / 2 (zeros outside)
  stage_span(span, audio + (size_t)b * N, (long)t0 * hop - NFFT / 2, (tf - 1) * hop + NFFT, N);
  fft_windowed<M>(buf, tf, tw, span, hop, win);

  float* out = power + ((size_t)b * T + t0) * K;
  for (int i = threadIdx.x; i < tf * K; i += THREADS) {
    const int f = i / K, k = i - f * K;
    const float2* z = buf + f * MP;
    const float2 x = split(z[padded(k & (M - 1))], z[padded((M - k) & (M - 1))], __ldg(tw + k));
    const float p = (t0 + f < nv) ? x.x * x.x + x.y * x.y : 0.f;
    P[i] = p;
    out[i] = p;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int f = warp; f < tf; f += THREADS / 32) {
    float m = -INFINITY;
    for (int k = lane; k < K; k += 32) m = fmaxf(m, P[f * K + k]);
    m = warp_max(m);
    if (lane == 0) fmax_s[f] = m;
  }
  __syncthreads();

  const int W = hi - lo;
  for (int i = threadIdx.x; i < tf * W; i += THREADS) {
    const int f = i / W, j = i - f * W;
    float mg, ix;
    candidate_at(P + f * K, lo + j, fmax_s[f], __ldg(rtab + lo + j), c_ln2, mg, ix);
    const size_t o = ((size_t)b * T + t0 + f) * W + j;
    mags[o] = mg;
    idxm[o] = ix;
  }

  // mel band m: the sum over its nonzero bins [start, start + len)
  for (int i = threadIdx.x; i < tf * n_mels; i += THREADS) {
    const int f = i / n_mels, m = i - f * n_mels;
    const int start = __ldg(mel_ranges + 3 * m), len = __ldg(mel_ranges + 3 * m + 1);
    const float* w = mel_w + __ldg(mel_ranges + 3 * m + 2);
    const float* p = P + f * K + start;
    float acc = 0.f;
    for (int j = 0; j < len; ++j) acc += p[j] * __ldg(w + j);
    mel[((size_t)b * T + t0) * n_mels + i] = db ? db_of(acc) : acc;
  }
}

__device__ inline float block_max(float v, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < nwarps ? red[lane] : -INFINITY;
    v = warp_max(v);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  v = red[0];
  __syncthreads();
  return v;
}

__global__ void spectromel_stats(const float* __restrict__ mel, const int* __restrict__ lengths,
                                 int T, int M, int hop, const float* __restrict__ dctT, int C,
                                 const float* __restrict__ sg, float* __restrict__ stats) {
  extern __shared__ __align__(16) float smem[];
  float* mf = smem;         // [T * C] MFCC
  float* d1 = mf + T * C;   // [T * C] delta
  float* d2 = d1 + T * C;   // [T * C] delta-delta
  __shared__ float red[32];

  const int b = blockIdx.x;
  const int nv = min(1 + lengths[b] / hop, T);
  const float* X = mel + (size_t)b * T * M;

  float m = -INFINITY;
  for (int i = threadIdx.x; i < nv * M; i += blockDim.x) m = fmaxf(m, X[i]);
  const float floor_db = block_max(m, red) - 80.0f;

  for (int i = threadIdx.x; i < T * C; i += blockDim.x) {
    const int t = i / C, c = i - t * C;
    const float* row = X + (size_t)t * M;
    float acc = 0.f;
    for (int j = 0; j < M; ++j) acc += fmaxf(row[j], floor_db) * dctT[j * C + c];
    mf[i] = acc;
  }
  __syncthreads();

  const int start = max(nv - WIDTH, 0);
  for (int i = threadIdx.x; i < nv * C; i += blockDim.x) {
    const int t = i / C, c = i - t * C;
    const int e = t - (nv - HALF);
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      const float* taps = sg + o * SG_ROWS * WIDTH;
      float acc = 0.f;
      if (e >= 0 && e < HALF) {  // last edge, at this clip's own n_valid
        const float* row = taps + (1 + HALF + e) * WIDTH;
        for (int w = 0; w < WIDTH; ++w) acc += row[w] * mf[(start + w) * C + c];
      } else if (t < HALF) {  // first edge
        const float* row = taps + (1 + t) * WIDTH;
        for (int w = 0; w < WIDTH; ++w) acc += row[w] * mf[w * C + c];
      } else {  // interior; zero beyond the bucket's last frame
        for (int j = 0; j < WIDTH; ++j) {
          const int src = t + j - HALF;
          if (src < T) acc += taps[j] * mf[src * C + c];
        }
      }
      (o == 0 ? d1 : d2)[i] = acc;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const float cnt = (float)max(nv, 1);
  for (int col = warp; col < 3 * C; col += nwarps) {
    const float* x = smem + (col / C) * T * C;
    const int c = col % C;
    float s = 0.f;
    for (int t = lane; t < nv; t += 32) s += x[t * C + c];
    const float mean = warp_sum(s) / cnt;
    float v = 0.f;
    for (int t = lane; t < nv; t += 32) {
      const float d = x[t * C + c] - mean;
      v += d * d;
    }
    const float stdv = sqrtf(warp_sum(v) / cnt);
    if (lane == 0) {
      float* out = stats + ((size_t)b * 6 + 2 * (col / C)) * C + c;
      out[0] = mean;
      out[C] = stdv;
    }
  }
}

// Order-preserving map of f32 to u32 (negative values reversed) and back.
__device__ inline unsigned ordered_key(float x) {
  const unsigned u = __float_as_uint(x);
  return (u >> 31) ? ~u : (u | 0x80000000u);
}

__device__ inline float from_key(unsigned k) {
  return __uint_as_float((k >> 31) ? (k & 0x7FFFFFFFu) : ~k);
}

constexpr int TUNE_BINS = 100;

__global__ void tuning_tail(const float* __restrict__ mags, const float* __restrict__ idxm,
                            int n, int* __restrict__ tb) {
  __shared__ unsigned hist[2][256];
  __shared__ int counts[TUNE_BINS];
  __shared__ unsigned prefix[2], rank[2];
  __shared__ int n_cand;
  const int b = blockIdx.x;
  const float* m = mags + (size_t)b * n;
  const float* ix = idxm + (size_t)b * n;

  if (threadIdx.x == 0) n_cand = 0;
  __syncthreads();
  int c = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) c += ix[i] >= 0.f;
  for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
  if ((threadIdx.x & 31) == 0) atomicAdd(&n_cand, c);
  __syncthreads();
  const int cnt = n_cand;
  if (cnt == 0) {  // librosa's no-candidate tuning 0.0
    if (threadIdx.x == 0) tb[b] = TUNE_BINS / 2;
    return;
  }
  if (threadIdx.x == 0) {
    rank[0] = (unsigned)(cnt - 1) / 2;  // the two middle order statistics
    rank[1] = (unsigned)cnt / 2;
    prefix[0] = prefix[1] = 0u;
  }
  // radix select, 8 bits per pass from the top, both ranks in each pass
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 2 * 256; i += blockDim.x) (&hist[0][0])[i] = 0u;
    __syncthreads();
    const unsigned hi_mask = shift == 24 ? 0u : 0xFFFFFFFFu << (shift + 8);
    const unsigned p0 = prefix[0], p1 = prefix[1];
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      if (ix[i] < 0.f) continue;
      const unsigned k = ordered_key(m[i]);
      const unsigned d = (k >> shift) & 255u;
      if ((k & hi_mask) == p0) atomicAdd(&hist[0][d], 1u);
      if ((k & hi_mask) == p1) atomicAdd(&hist[1][d], 1u);
    }
    __syncthreads();
    if (threadIdx.x < 2) {
      const int s = threadIdx.x;
      unsigned r = rank[s], below = 0u;
      int d = 0;
      for (; d < 255 && r >= below + hist[s][d]; ++d) below += hist[s][d];
      prefix[s] |= (unsigned)d << shift;
      rank[s] = r - below;
    }
    __syncthreads();
  }
  const float med = __fmul_rn(0.5f, __fadd_rn(from_key(prefix[0]), from_key(prefix[1])));

  for (int i = threadIdx.x; i < TUNE_BINS; i += blockDim.x) counts[i] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float bin = ix[i];
    if (bin >= 0.f && m[i] >= med) atomicAdd(&counts[(int)bin], 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // the first maximum
    int best = 0;
    for (int d = 1; d < TUNE_BINS; ++d)
      if (counts[d] > counts[best]) best = d;
    tb[b] = best;
  }
}

template <int M>
cudaError_t launch_frames(const float* audio, const int* lengths, const float* win,
                          const float2* tw, const int* mel_ranges, const float* mel_w,
                          const float* rtab, float* power, float* mel, float* mags, float* idxm,
                          int B, int N, int hop, int F, int n_mels, int lo, int hi, float c_ln2,
                          int db, cudaStream_t s) {
  const int T = N / hop + 1;
  const size_t smem =
      sizeof(float) * ((size_t)2 * F * frame_stride<M>() + F * (M + 1) + (F - 1) * hop + 2 * M);
  if (F * M > TILE_POINTS || smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(spectromel_frames<M>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  spectromel_frames<M><<<dim3((T + F - 1) / F, B), THREADS, smem, s>>>(
      audio, lengths, N, T, hop, F, win, tw, mel_ranges, mel_w, n_mels, rtab, lo, hi, c_ln2, db,
      power, mel, mags, idxm);
  return cudaGetLastError();
}

// Launch 1 at any supported n_fft (512, 1024 or 2048), even hop, hop | N.
cudaError_t launch_front(const void* audio, const void* lengths, const void* win, const void* tw,
                         const void* mel_ranges, const void* mel_w, const void* rtab,
                         void* power, void* mel, void* mags, void* idxm, int B, int N, int n_fft,
                         int hop, int F, int n_mels, int lo, int hi, float c_ln2, int db,
                         cudaStream_t s) {
  if (hop < 2 || hop % 2 != 0 || N % hop != 0 || F < 1 || lo < 1 || hi >= n_fft / 2 + 1 ||
      lo >= hi)
    return cudaErrorInvalidValue;
  decltype(&launch_frames<256>) launch = nullptr;
  if (n_fft == 512) launch = &launch_frames<256>;
  if (n_fft == 1024) launch = &launch_frames<512>;
  if (n_fft == 2048) launch = &launch_frames<1024>;
  if (launch == nullptr) return cudaErrorInvalidValue;
  return launch((const float*)audio, (const int*)lengths, (const float*)win, (const float2*)tw,
                (const int*)mel_ranges, (const float*)mel_w, (const float*)rtab, (float*)power,
                (float*)mel, (float*)mags, (float*)idxm, B, N, hop, F, n_mels, lo, hi, c_ln2, db, s);
}

}  // namespace

// Stats mode: launches 1, 2 and 3.  F: frames per tile of launch 1.
extern "C" int spectromel_launch(const void* audio, const void* lengths, const void* win,
                                 const void* tw, const void* mel_ranges, const void* mel_w,
                                 const void* rtab, const void* dctT, const void* sg, void* power,
                                 void* mel, void* mags, void* idxm, void* stats, void* tb, int B,
                                 int N, int n_fft, int hop, int F, int M, int C, int lo, int hi,
                                 float c_ln2, void* stream) {
  if (hop < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int T = N / hop + 1;
  const size_t smem = sizeof(float) * 3 * (size_t)T * C;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_front(audio, lengths, win, tw, mel_ranges, mel_w, rtab, power, mel,
                                 mags, idxm, B, N, n_fft, hop, F, M, lo, hi, c_ln2, 1, s);
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(spectromel_stats, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  spectromel_stats<<<B, 256, smem, s>>>((const float*)mel, (const int*)lengths, T, M, hop,
                                        (const float*)dctT, C, (const float*)sg, (float*)stats);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  tuning_tail<<<B, 512, 0, s>>>((const float*)mags, (const float*)idxm, T * (hi - lo), (int*)tb);
  return (int)cudaGetLastError();
}

// Mel-output mode: launches 1 and 3.
extern "C" int spectromel_mel_launch(const void* audio, const void* lengths, const void* win,
                                     const void* tw, const void* mel_ranges, const void* mel_w,
                                     const void* rtab, void* power, void* mel, void* mags,
                                     void* idxm, void* tb, int B, int N, int n_fft, int hop, int F,
                                     int M, int lo, int hi, float c_ln2, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch_front(audio, lengths, win, tw, mel_ranges, mel_w, rtab, power, mel,
                                 mags, idxm, B, N, n_fft, hop, F, M, lo, hi, c_ln2, 0, s);
  if (err != cudaSuccess) return (int)err;
  const int T = N / hop + 1;  // launch_front checked hop
  tuning_tail<<<B, 512, 0, s>>>((const float*)mags, (const float*)idxm, T * (hi - lo), (int*)tb);
  return (int)cudaGetLastError();
}
