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
//     candidates of the 150-4000 Hz band, and the mel spectrum as a sum over
//     each band's nonzero bin range (a host table [start, length, offset]
//     plus the weights, which rebuilds mel_fb exactly; ops/consts.py) --
//     in stats mode already in dB (10 log10 max(mel, 1e-10)), once a value.
//     The candidates leave compacted: local maxima are never adjacent (a
//     candidate's left neighbour is strictly below it, its right neighbour
//     not above it), so a frame of W band bins holds at most cap =
//     ceil(W / 2).  A warp walks its frame's band 32 bins at a time: a
//     ballot marks the chunk's candidates and a candidate's slot is the
//     count so far plus the popcount of the ballot below its lane, so frame
//     t's candidates land in bin order in slots 0 .. n_t - 1 of its row of
//     `cap` slots -- as the order-preserving u32 key of the
//     magnitude (`ordered_key`) and the histogram bin as one byte -- and
//     n_t goes to counts [B, T].  The layout is deterministic; the tail's
//     result would be exact in any slot order, since it counts integers.
//  2. spectromel_stats (stats mode only), one block per clip: librosa
//     power_to_db's 80 dB clamp under the max over valid frames, the
//     orthonormal DCT-II, SavGol delta and delta-delta (width 9; interior
//     taps, static first edge, last edge at the clip's own n_valid), and the
//     masked mean and population std -> stats [B, 6, n_mfcc].
//  3. tuning_tail, one block of 512 threads per clip: the tuning bin from
//     the compacted candidates, as ops/chroma.py:tuning_bin_from_candidates
//     (XLA in the JAX package, stutter_tpu/ops/chroma.py:213) computes it --
//     the exact median of the candidate magnitudes by radix selection on the
//     keys (8 bits a pass, both middle ranks in each pass), then the first
//     maximum of the 100-bin histogram of the candidates at or above it
//     (integer shared-memory counts, so exact), bin 50 when there is no
//     candidate.  It scans the clip's frame counts into offsets, reads every
//     candidate once from device memory into shared memory (flat index ->
//     frame by binary search over the offsets), and runs the four select
//     passes and the histogram from there; the digit of each pass and the
//     first maximum are found by a warp scan and a warp argmax, not a serial
//     loop.  Over capacity: a 3 s clip at n_fft 2048 holds at most 97 x 246
//     candidates (119 KB at 5 bytes), which fits the block's shared memory,
//     and so does the mel mode's 10 s clip (641 x 62), but a 10 s clip at
//     n_fft 2048 can hold up to 321 x 246 (395 KB), which does not.  Such a
//     clip takes a second path inside the same kernel: the same passes read
//     the candidates from the compacted arrays in device memory (five walks,
//     from L2 at these sizes).  Chosen over a cluster with the histograms in
//     distributed shared memory because a clip needs that many candidates
//     only when nearly every other bin of nearly every frame is a peak above
//     a tenth of the frame's max (a comb of tones; speech and noise hold a
//     fraction of it), so the path is rare, while a cluster would tie up to
//     eight SMs for every clip.
//
// Bounds on an H100: launch 1 reads the audio once (from shared memory
// n_fft / hop times) and writes power, mel and the compacted candidates;
// its FFTs are ~5 n log2 n / 2 FLOP a frame, far below the FP32 rate, so
// the launch is bound by those bytes.  A clip's power (97 x 1025 f32 at
// 3 s) does not fit one SM's shared memory, hence frame tiles, the mel
// written for launch 2, and the per-clip stats launch.  The tail is bound
// by its reads (the counts and 5 bytes a candidate) and, at a request, by
// its latency: one block per clip, a handful of block-wide barriers a pass.
//
// The candidate arithmetic uses __f*_rn intrinsics, which the compiler never
// fuses into FMAs: every operation rounds as the plain PyTorch version's
// separate elementwise ops do, so the tuning bin computed from the kernel's
// own power matches the plain estimate on that power exactly.
#include <algorithm>

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

// Order-preserving map of f32 to u32 (negative values reversed) and back.
__device__ inline unsigned ordered_key(float x) {
  const unsigned u = __float_as_uint(x);
  return (u >> 31) ? ~u : (u | 0x80000000u);
}

__device__ inline float from_key(unsigned k) {
  return __uint_as_float((k >> 31) ? (k & 0x7FFFFFFFu) : ~k);
}

__device__ inline float db_of(float x) { return 10.0f * log10f(fmaxf(x, 1e-10f)); }

// One block per (clip, tile of F frames): power, mel (in dB when `db`: the
// stats mode's only use of it) and the compacted candidates.
template <int M>
__global__ void __launch_bounds__(THREADS)
    spectromel_frames(const float* __restrict__ audio, const int* __restrict__ lengths, int N,
                      int T, int hop, int F, const float* __restrict__ win,
                      const float2* __restrict__ tw, const int* __restrict__ mel_ranges,
                      const float* __restrict__ mel_w, int n_mels,
                      const float* __restrict__ rtab, int lo, int hi, float c_ln2, int db,
                      float* __restrict__ power, float* __restrict__ mel,
                      unsigned* __restrict__ keys, unsigned char* __restrict__ bins,
                      int* __restrict__ counts) {
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

  // candidates, compacted per frame (header, launch 1): a warp walks its
  // frame's band 32 bins at a time, the running count its base
  const int W = hi - lo, cap = (W + 1) >> 1;
  for (int f = warp; f < tf; f += THREADS / 32) {
    const size_t row = (size_t)b * T + t0 + f;
    unsigned* key = keys + row * cap;
    unsigned char* bin = bins + row * cap;
    int base = 0;
    for (int j = lane; j - lane < W; j += 32) {
      float mg = 0.f, ix = -1.f;
      if (j < W) candidate_at(P + f * K, lo + j, fmax_s[f], __ldg(rtab + lo + j), c_ln2, mg, ix);
      const unsigned m = __ballot_sync(0xffffffffu, ix >= 0.f);
      if ((m >> lane) & 1u) {
        const int o = base + __popc(m & ((1u << lane) - 1u));
        key[o] = ordered_key(mg);
        bin[o] = (unsigned char)ix;
      }
      base += __popc(m);
    }
    if (lane == 0) counts[row] = base;
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

constexpr int TUNE_BINS = 100;
constexpr int TAIL_THREADS = 512;

// Frame of flat candidate i: the t with off[t] <= i < off[t + 1].
__device__ inline int frame_of(const int* off, int T, int i) {
  int lo = 0, hi = T;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (off[mid] <= i) lo = mid; else hi = mid;
  }
  return lo;
}

// Candidate i of a clip: from shared memory (SMEM) or from the compacted
// arrays in device memory (the over-capacity path).
template <bool SMEM>
struct Candidates {
  const unsigned* key;       // SMEM: [n]; else the clip's [T, cap] rows
  const unsigned char* bin;
  const int* off;            // [T + 1] in shared memory
  int T, cap;
  __device__ void at(int i, unsigned& k, int& d) const {
    if (SMEM) {
      k = key[i];
      d = bin[i];
    } else {
      const int t = frame_of(off, T, i);
      const size_t o = (size_t)t * cap + (i - off[t]);
      k = key[o];
      d = bin[o];
    }
  }
};

// One warp finds the digit of the rank in a 256-bin histogram: lane L holds
// bins 8L .. 8L + 7, a warp scan gives each lane the count below its bins,
// and the lane whose bins hold the rank walks its 8 (the rank is below the
// histogram's total, so one lane does).  It adds the digit to the prefix
// and leaves the rank within the digit.
__device__ inline void warp_digit(const unsigned* h, int shift, unsigned* prefix, unsigned* rank) {
  const int lane = threadIdx.x & 31;
  const unsigned r = *rank;
  unsigned v[8], local = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j) local += (v[j] = h[8 * lane + j]);
  unsigned incl = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned x = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += x;
  }
  const unsigned hit = __ballot_sync(0xffffffffu, incl > r);
  if (lane == __ffs(hit) - 1) {
    unsigned below = incl - local;
    int j = 0;
    for (; j < 7 && r >= below + v[j]; ++j) below += v[j];
    *prefix |= (unsigned)(8 * lane + j) << shift;
    *rank = r - below;
  }
}

struct TailShared {
  unsigned hist[2][256];
  int counts[TUNE_BINS];
  unsigned prefix[2], rank[2];
};

// The median of the clip's n > 0 candidates and the first maximum of their
// histogram at or above it -> *out.
template <bool SMEM>
__device__ void select_and_histogram(const Candidates<SMEM>& c, int n, TailShared& sh, int* out) {
  unsigned(&hist)[2][256] = sh.hist;
  int(&counts)[TUNE_BINS] = sh.counts;
  unsigned(&prefix)[2] = sh.prefix;
  unsigned(&rank)[2] = sh.rank;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    rank[0] = (unsigned)(n - 1) / 2;  // the two middle order statistics
    rank[1] = (unsigned)n / 2;
    prefix[0] = prefix[1] = 0u;
  }
  // radix select, 8 bits per pass from the top, both ranks in each pass
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 2 * 256; i += TAIL_THREADS) (&hist[0][0])[i] = 0u;
    __syncthreads();
    const unsigned hi_mask = shift == 24 ? 0u : 0xFFFFFFFFu << (shift + 8);
    const unsigned p0 = prefix[0], p1 = prefix[1];
    for (int i = threadIdx.x; i < n; i += TAIL_THREADS) {
      unsigned k;
      int d;
      c.at(i, k, d);
      const unsigned digit = (k >> shift) & 255u;
      if ((k & hi_mask) == p0) atomicAdd(&hist[0][digit], 1u);
      if ((k & hi_mask) == p1) atomicAdd(&hist[1][digit], 1u);
    }
    __syncthreads();
    if (warp < 2) warp_digit(hist[warp], shift, &prefix[warp], &rank[warp]);
    __syncthreads();
  }
  const float med = __fmul_rn(0.5f, __fadd_rn(from_key(prefix[0]), from_key(prefix[1])));

  for (int i = threadIdx.x; i < TUNE_BINS; i += TAIL_THREADS) counts[i] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += TAIL_THREADS) {
    unsigned k;
    int d;
    c.at(i, k, d);
    if (from_key(k) >= med) atomicAdd(&counts[min(d, TUNE_BINS - 1)], 1);
  }
  __syncthreads();
  if (warp == 0) {  // the first maximum: the lowest bin of the highest count
    int best = -1, arg = 0;
    for (int d = lane; d < TUNE_BINS; d += 32)
      if (counts[d] > best) best = counts[d], arg = d;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const int ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oa = __shfl_xor_sync(0xffffffffu, arg, o);
      if (ob > best || (ob == best && oa < arg)) best = ob, arg = oa;
    }
    if (lane == 0) *out = arg;
  }
}

// Shared memory of the tail: the offsets [T + 1], 16-byte rounded, then
// `capacity` keys and as many bins.
__host__ __device__ inline int tail_offset_bytes(int T) { return ((T + 1) * 4 + 15) & ~15; }

// One block per clip (header, launch 3).
__global__ void __launch_bounds__(TAIL_THREADS)
    tuning_tail(const unsigned* __restrict__ keys, const unsigned char* __restrict__ bins,
                const int* __restrict__ counts, int T, int cap, int capacity,
                int* __restrict__ tb) {
  extern __shared__ __align__(16) unsigned char tsm[];
  __shared__ TailShared sh;
  int* off = reinterpret_cast<int*>(tsm);  // [T + 1]
  unsigned* skey = reinterpret_cast<unsigned*>(tsm + tail_offset_bytes(T));
  unsigned char* sbin = reinterpret_cast<unsigned char*>(skey + capacity);
  const int b = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned* gkey = keys + (size_t)b * T * cap;
  const unsigned char* gbin = bins + (size_t)b * T * cap;

  // the frame counts -> offsets; warp 0 scans, lane L over a run of frames
  for (int t = threadIdx.x; t < T; t += TAIL_THREADS) off[t + 1] = counts[(size_t)b * T + t];
  __syncthreads();
  if (warp == 0) {
    const int per = (T + 31) / 32, t0 = min(lane * per, T), t1 = min(t0 + per, T);
    int local = 0;
    for (int t = t0; t < t1; ++t) local += off[t + 1];
    int run = local;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, run, o);
      if (lane >= o) run += x;
    }
    run -= local;
    for (int t = t0; t < t1; ++t) off[t + 1] = (run += off[t + 1]);
    if (lane == 0) off[0] = 0;
  }
  __syncthreads();
  const int n = off[T];
  if (n == 0) {  // librosa's no-candidate tuning 0.0
    if (threadIdx.x == 0) tb[b] = TUNE_BINS / 2;
    return;
  }
  if (n > capacity) {  // over capacity: every pass reads device memory (header)
    select_and_histogram(Candidates<false>{gkey, gbin, off, T, cap}, n, sh, tb + b);
    return;
  }
  // every candidate read once, four loads in flight a thread
  for (int i0 = threadIdx.x; i0 < n; i0 += 4 * TAIL_THREADS) {
    unsigned k[4];
    unsigned char d[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * TAIL_THREADS;
      if (i < n) {
        const int t = frame_of(off, T, i);
        const size_t o = (size_t)t * cap + (i - off[t]);
        k[u] = gkey[o];
        d[u] = gbin[o];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * TAIL_THREADS;
      if (i < n) {
        skey[i] = k[u];
        sbin[i] = d[u];
      }
    }
  }
  __syncthreads();
  select_and_histogram(Candidates<true>{skey, sbin, off, T, cap}, n, sh, tb + b);
}

cudaError_t launch_tail(const unsigned* keys, const unsigned char* bins, const int* counts,
                        int* tb, int B, int T, int cap, cudaStream_t s) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, tuning_tail);
  if (err != cudaSuccess) return err;
  const size_t room = MAX_SMEM - fa.sharedSizeBytes, offb = (size_t)tail_offset_bytes(T);
  if (offb + 5 * 512 > room) return cudaErrorInvalidValue;
  // the bucket's most candidates, or as many as fit
  const size_t smem = std::min(offb + 5 * (size_t)T * cap, room);
  const int capacity = (int)((smem - offb) / 5);
  err = cudaFuncSetAttribute(tuning_tail, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  tuning_tail<<<B, TAIL_THREADS, smem, s>>>(keys, bins, counts, T, cap, capacity, tb);
  return cudaGetLastError();
}

template <int M>
cudaError_t launch_frames(const float* audio, const int* lengths, const float* win,
                          const float2* tw, const int* mel_ranges, const float* mel_w,
                          const float* rtab, float* power, float* mel, unsigned* keys,
                          unsigned char* bins, int* counts, int B, int N, int hop, int F,
                          int n_mels, int lo, int hi, float c_ln2, int db, cudaStream_t s) {
  const int T = N / hop + 1;
  const size_t smem =
      sizeof(float) * ((size_t)2 * F * frame_stride<M>() + F * (M + 1) + (F - 1) * hop + 2 * M);
  if (F * M > TILE_POINTS || smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(spectromel_frames<M>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  spectromel_frames<M><<<dim3((T + F - 1) / F, B), THREADS, smem, s>>>(
      audio, lengths, N, T, hop, F, win, tw, mel_ranges, mel_w, n_mels, rtab, lo, hi, c_ln2, db,
      power, mel, keys, bins, counts);
  return cudaGetLastError();
}

// Launch 1 at any supported n_fft (512, 1024 or 2048), even hop, hop | N.
cudaError_t launch_front(const void* audio, const void* lengths, const void* win, const void* tw,
                         const void* mel_ranges, const void* mel_w, const void* rtab,
                         void* power, void* mel, void* keys, void* bins, void* counts, int B,
                         int N, int n_fft, int hop, int F, int n_mels, int lo, int hi,
                         float c_ln2, int db, cudaStream_t s) {
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
                (float*)mel, (unsigned*)keys, (unsigned char*)bins, (int*)counts, B, N, hop, F,
                n_mels, lo, hi, c_ln2, db, s);
}

}  // namespace

// Stats mode: launches 1, 2 and 3.  F: frames per tile of launch 1; keys,
// bins: [B, T, ceil((hi - lo) / 2)] candidate slots, counts [B, T].
extern "C" int spectromel_launch(const void* audio, const void* lengths, const void* win,
                                 const void* tw, const void* mel_ranges, const void* mel_w,
                                 const void* rtab, const void* dctT, const void* sg, void* power,
                                 void* mel, void* keys, void* bins, void* counts, void* stats,
                                 void* tb, int B, int N, int n_fft, int hop, int F, int M, int C,
                                 int lo, int hi, float c_ln2, void* stream) {
  if (hop < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int T = N / hop + 1;
  const size_t smem = sizeof(float) * 3 * (size_t)T * C;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_front(audio, lengths, win, tw, mel_ranges, mel_w, rtab, power, mel,
                                 keys, bins, counts, B, N, n_fft, hop, F, M, lo, hi, c_ln2, 1, s);
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(spectromel_stats, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  spectromel_stats<<<B, 256, smem, s>>>((const float*)mel, (const int*)lengths, T, M, hop,
                                        (const float*)dctT, C, (const float*)sg, (float*)stats);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  return (int)launch_tail((const unsigned*)keys, (const unsigned char*)bins, (const int*)counts,
                          (int*)tb, B, T, (hi - lo + 1) / 2, s);
}

// Mel-output mode: launches 1 and 3; launch 1 alone when tb is null (the
// sequence featurizer, which reads no tuning bin).
extern "C" int spectromel_mel_launch(const void* audio, const void* lengths, const void* win,
                                     const void* tw, const void* mel_ranges, const void* mel_w,
                                     const void* rtab, void* power, void* mel, void* keys,
                                     void* bins, void* counts, void* tb, int B, int N, int n_fft,
                                     int hop, int F, int M, int lo, int hi, float c_ln2,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch_front(audio, lengths, win, tw, mel_ranges, mel_w, rtab, power, mel,
                                 keys, bins, counts, B, N, n_fft, hop, F, M, lo, hi, c_ln2, 0, s);
  if (err != cudaSuccess || tb == nullptr) return (int)err;
  const int T = N / hop + 1;  // launch_front checked hop
  return (int)launch_tail((const unsigned*)keys, (const unsigned char*)bins, (const int*)counts,
                          (int*)tb, B, T, (hi - lo + 1) / 2, s);
}
