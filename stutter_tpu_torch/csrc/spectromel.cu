// Fused spectromel kernel for Hopper (sm_90a), FP32.
//
// Replaces stutter_tpu/ops/pallas_spectromel.py:spectromel_pallas with
// with_tuning=True (body _spectromel_kernel, _candidates_of, _mfcc_stats_of)
// in both of its output modes:
//
//  * stats mode (with_stats=True; the 149-dim front end, n_fft = 4 * hop):
//    power [B, T, K], MFCC/delta statistics [B, 6, n_mfcc], tuning bin [B];
//    launches 1-5 below (`spectromel_launch`).
//  * mel-output mode (with_stats=False; the 286-dim variant at n_fft 512,
//    hop 256, through ops/frontend.py:spect_mel_db): power [B, T, K], the
//    linear mel spectrum [B, T, M] and the tuning bin [B]; launches 1, 2, 3
//    and 5 (`spectromel_mel_launch`), for n_fft / hop = 2 or 4.  Launch 4
//    is not run: at the variant's 10 s bucket its per-clip MFCC/delta
//    buffers would need 3 * 641 * 40 * 4 B = 307 KB of shared memory, over
//    the 227 KB a block can get, and the variant reduces the mel spectrum
//    in plain PyTorch (ops/frontend334.py) as the JAX package does in XLA.
//
//  1. chunk_dft (chunk_stft.cuh): Z = hop chunks x [cos | sin], one GEMM
//     over all clips' chunks, read straight from the audio.
//  2. spectromel_frames<R>, one block per (clip, tile of TF frames): X from
//     Z (phase recombination over R = n_fft / hop slots), the 3-tap Hann,
//     |.|^2 and the frame mask -> power [B, T, K] (the chroma kernel reads
//     it too); then, on the tile's power in shared memory, each frame's max
//     and the piptrack candidates of the 150-4000 Hz band in the port's
//     uncompacted layout (mags, residual bin as f32 or -1).
//  3. mel_gemm: mel [B * T, M] = power x mel filterbank^T.
//  4. spectromel_stats (stats mode only), one block per clip: librosa
//     power_to_db with the 80 dB clamp under the max over valid frames, the
//     orthonormal DCT-II, SavGol delta and delta-delta (width 9; interior
//     taps, static first edge, last edge at the clip's own n_valid), and the
//     masked mean and population std -> stats [B, 6, n_mfcc].
//  5. tuning_tail, one block per clip: the tuning bin from the candidates,
//     as ops/chroma.py:tuning_bin_from_candidates (XLA in the JAX package,
//     stutter_tpu/ops/chroma.py:213) computes it -- the exact median of the
//     candidate magnitudes by radix selection on order-preserving u32 keys,
//     then the first maximum of the 100-bin histogram of the candidates at
//     or above it (integer shared-memory counts, so exact), bin 50 when
//     there is no candidate.
//
// Bounds on an H100: the chunk DFT GEMM, [B * C, hop] x [hop, 2K], is ~90 %
// of the FLOPs (0.21 GFLOP per 3 s clip) and is bound by FP32 issue on the
// CUDA cores (TF32 tensor cores would break the 1e-5 power bound).  Z
// (0.8 MB per 3 s clip) and the power make a round trip through device
// memory, which costs far less than the GEMM at 3.35 TB/s.  A clip's power
// (97 x 1025 f32 at 3 s) does not fit in one SM's shared memory, hence frame
// tiles and the per-clip stats launch.  At the variant's geometry (K = 257,
// ratio 2) the chunk DFT is 8x smaller per sample and the mel GEMM (inner
// dimension 257, ragged against the 8-deep k tiles, which read zeros past
// it) and the candidate pass over the longer frame axis (641 frames x 123
// bins per 10 s clip) weigh more.
//
// The candidate arithmetic uses __f*_rn intrinsics, which the compiler never
// fuses into FMAs: every operation rounds as the plain PyTorch version's
// separate elementwise ops do, so the tuning bin matches exactly.
#include "chunk_stft.cuh"

using namespace chunk_stft;

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
  const float avg = __fmul_rn(0.5f, __fsub_rn(hp, hm));
  const float den = __fsub_rn(__fsub_rn(__fmul_rn(2.0f, sb), hp), hm);
  const float shift = __fdiv_rn(avg, __fadd_rn(den, fabsf(den) < F32_TINY ? 1.0f : 0.0f));
  const float dskew = __fmul_rn(__fmul_rn(0.5f, avg), shift);
  const float g = sb > ref ? sb : 0.f;
  const float gm = hm > ref ? hm : 0.f;
  const float gp = hp > ref ? hp : 0.f;
  const float binf = (float)k;
  if (!((g > gm) && (g >= gp) && (__fadd_rn(binf, shift) > 0.f))) {
    mag = 0.f;
    idx = -1.f;
    return;
  }
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

template <int R>
__global__ void spectromel_frames(const float* __restrict__ Z, const int* __restrict__ lengths,
                                  int C, int T, int K, int hop, const float* __restrict__ pre,
                                  const float* __restrict__ pim, const float* __restrict__ rtab,
                                  int lo, int hi, float c_ln2, float* __restrict__ power,
                                  float* __restrict__ mags, float* __restrict__ idxm) {
  extern __shared__ __align__(16) float smem[];
  float* Xr = smem;          // [TF * K] X real, later the tile's power
  float* Xi = Xr + TF * K;   // [TF * K] X imaginary
  __shared__ float fmax_s[TF];

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TF;
  const int tf = min(TF, T - t0);
  const int nv = 1 + lengths[b] / hop;

  recombine_tile<R>(Z, C, K, b, t0, tf, pre, pim, Xr, Xi);
  __syncthreads();

  float* P = power + ((size_t)b * T + t0) * K;
  for (int i = threadIdx.x; i < tf * K; i += blockDim.x) {
    const int t = i / K, k = i - t * K;
    float yr, yi;
    hann3(Xr + t * K, Xi + t * K, k, K, yr, yi);
    P[i] = (t0 + t < nv) ? yr * yr + yi * yi : 0.f;
  }
  __syncthreads();  // makes the block's global writes visible to the block
  for (int i = threadIdx.x; i < tf * K; i += blockDim.x) Xr[i] = P[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int t = warp; t < tf; t += nwarps) {
    float m = -INFINITY;
    for (int k = lane; k < K; k += 32) m = fmaxf(m, Xr[t * K + k]);
    m = warp_max(m);
    if (lane == 0) fmax_s[t] = m;
  }
  __syncthreads();

  const int W = hi - lo;
  for (int i = threadIdx.x; i < tf * W; i += blockDim.x) {
    const int t = i / W, j = i - t * W;
    float mg, ix;
    candidate_at(Xr + t * K, lo + j, fmax_s[t], rtab[lo + j], c_ln2, mg, ix);
    const size_t o = ((size_t)b * T + t0 + t) * W + j;
    mags[o] = mg;
    idxm[o] = ix;
  }
}

template <int TM>
__global__ void __launch_bounds__(sgemm::THREADS)
    mel_gemm(sgemm::Dense power, sgemm::Dense melT, float* __restrict__ mel) {
  constexpr int S = sgemm::Geometry<TM>::S;
  float acc[TM][TM];
  sgemm::zero(acc);
  sgemm::tile(blockIdx.y * S, blockIdx.x * S, power.cols, power, melT, acc);
  sgemm::store(mel, power.rows, melT.cols, melT.cols, blockIdx.y * S, blockIdx.x * S, acc);
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

__device__ inline float db_of(float x) { return 10.0f * log10f(fmaxf(x, 1e-10f)); }

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
  for (int i = threadIdx.x; i < nv * M; i += blockDim.x) m = fmaxf(m, db_of(X[i]));
  const float floor_db = block_max(m, red) - 80.0f;

  for (int i = threadIdx.x; i < T * C; i += blockDim.x) {
    const int t = i / C, c = i - t * C;
    const float* row = X + (size_t)t * M;
    float acc = 0.f;
    for (int j = 0; j < M; ++j) acc += fmaxf(db_of(row[j]), floor_db) * dctT[j * C + c];
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

// Launches 1-3 at ratio R = n_fft / hop: power, mel and the candidates.
template <int R>
cudaError_t launch_front(const float* audio, const int* lengths, const float* tab,
                         const float* pre, const float* pim, const float* melT,
                         const float* rtab, float* Z, float* power, float* mel, float* mags,
                         float* idxm, int B, int N, int n_fft, int hop, int M, int lo, int hi,
                         float c_ln2, cudaStream_t s) {
  const int K = n_fft / 2 + 1;
  const int T = N / hop + 1;
  const int n_chunks = T + R - 1;
  cudaError_t err = launch_chunk_dft(audio, N, B, n_chunks, n_fft / 2, hop, tab, K, Z, s);
  if (err != cudaSuccess) return err;

  const size_t smem = tile_smem_bytes(K);
  err = cudaFuncSetAttribute(spectromel_frames<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  spectromel_frames<R><<<dim3((T + TF - 1) / TF, B), threads_for(K), smem, s>>>(
      Z, lengths, n_chunks, T, K, hop, pre, pim, rtab, lo, hi, c_ln2, power, mags, idxm);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const sgemm::Dense P{power, B * T, K, K, 0};
  const sgemm::Dense Mt{melT, K, M, M, 0};
  if (sgemm::pick_tm(B * T, M, 1) == 8)
    mel_gemm<8><<<sgemm::grid_for(8, B * T, M, 1), sgemm::THREADS, 0, s>>>(P, Mt, mel);
  else
    mel_gemm<4><<<sgemm::grid_for(4, B * T, M, 1), sgemm::THREADS, 0, s>>>(P, Mt, mel);
  return cudaGetLastError();
}

bool bad_geometry(int N, int n_fft, int hop, int lo, int hi) {
  return hop % sgemm::BK != 0 || N % hop != 0 || lo < 1 || hi >= n_fft / 2 + 1;
}

}  // namespace

// Stats mode (launches 1-5), n_fft == 4 * hop.
extern "C" int spectromel_launch(const void* audio, const void* lengths, const void* tab,
                                 const void* pre, const void* pim, const void* melT,
                                 const void* rtab, const void* dctT, const void* sg, void* Z,
                                 void* power, void* mel, void* mags, void* idxm, void* stats,
                                 void* tb, int B, int N, int n_fft, int hop, int M, int C, int lo,
                                 int hi, float c_ln2, void* stream) {
  if (n_fft != 4 * hop || bad_geometry(N, n_fft, hop, lo, hi)) return (int)cudaErrorInvalidValue;
  const int T = N / hop + 1;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch_front<4>(
      (const float*)audio, (const int*)lengths, (const float*)tab, (const float*)pre,
      (const float*)pim, (const float*)melT, (const float*)rtab, (float*)Z, (float*)power,
      (float*)mel, (float*)mags, (float*)idxm, B, N, n_fft, hop, M, lo, hi, c_ln2, s);
  if (err != cudaSuccess) return (int)err;

  const size_t smem = sizeof(float) * 3 * (size_t)T * C;
  err = cudaFuncSetAttribute(spectromel_stats, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  spectromel_stats<<<B, 256, smem, s>>>((const float*)mel, (const int*)lengths, T, M, hop,
                                        (const float*)dctT, C, (const float*)sg, (float*)stats);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  tuning_tail<<<B, 512, 0, s>>>((const float*)mags, (const float*)idxm, T * (hi - lo), (int*)tb);
  return (int)cudaGetLastError();
}

// Mel-output mode (launches 1, 2, 3 and 5), n_fft == 2 * hop or 4 * hop.
extern "C" int spectromel_mel_launch(const void* audio, const void* lengths, const void* tab,
                                     const void* pre, const void* pim, const void* melT,
                                     const void* rtab, void* Z, void* power, void* mel,
                                     void* mags, void* idxm, void* tb, int B, int N, int n_fft,
                                     int hop, int M, int lo, int hi, float c_ln2, void* stream) {
  if ((n_fft != 2 * hop && n_fft != 4 * hop) || bad_geometry(N, n_fft, hop, lo, hi))
    return (int)cudaErrorInvalidValue;
  const int T = N / hop + 1;
  cudaStream_t s = (cudaStream_t)stream;
  decltype(&launch_front<4>) front = &launch_front<4>;
  if (n_fft == 2 * hop) front = &launch_front<2>;
  cudaError_t err = front((const float*)audio, (const int*)lengths, (const float*)tab,
                          (const float*)pre, (const float*)pim, (const float*)melT,
                          (const float*)rtab, (float*)Z, (float*)power, (float*)mel,
                          (float*)mags, (float*)idxm, B, N, n_fft, hop, M, lo, hi, c_ln2, s);
  if (err != cudaSuccess) return (int)err;
  tuning_tail<<<B, 512, 0, s>>>((const float*)mags, (const float*)idxm, T * (hi - lo), (int*)tb);
  return (int)cudaGetLastError();
}
