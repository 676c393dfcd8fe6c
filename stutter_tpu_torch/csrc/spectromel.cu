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
//  2. spectromel_stats (stats mode only), the body _mfcc_stats_of
//     (stutter_tpu/ops/pallas_spectromel.py:300): librosa power_to_db's 80 dB
//     clamp under the max over valid frames, the orthonormal DCT-II, SavGol
//     delta and delta-delta (width 9; interior taps, static first edge, last
//     edge at the clip's own n_valid), and the masked mean and population
//     std -> stats [B, 6, n_mfcc].  It reads the dB mel launch 1 wrote, and
//     only the frames it needs: the valid ones and, for a clip of fewer than
//     9, the masked frames up to 9 that its last-edge rows read.  Bound on
//     an H100 by those bytes (12.3 MB at B=256 x 3 s, 3.7 us at 3.35 TB/s;
//     the DCT's 123 MFLOP take 1.8 us at the FP32 rate), and at one request
//     by its latency: a chain of copies, barriers and short loops.  The
//     design:
//      * a thread-block cluster of cs <= 8 blocks per clip (portable), each
//        block owning a contiguous range of R valid frames
//        (ops/spectromel.py:stats_plan picks cs and R from B and T: one 3 s
//        request spreads over 8 SMs, a batch of 256 takes a block a clip),
//        so shared memory bounds a block's frames, not the clip's;
//      * a block's mel rows land in shared memory by bulk copies
//        (cp.async.bulk, one a row, into rows padded by 16 bytes) on one
//        mbarrier, with the DCT table: its own frames and the rows its
//        deltas read, 8 before (the interior's halo of 4, and a last-edge
//        window that starts up to 8 frames back) and 4 after.  Rows past
//        the clip's last needed frame are never read; a halo row is read by
//        two blocks, the second time from L2 in practice (the neighbour
//        reads it at the same moment), and costs a batch of 256 nothing
//        (a block a clip);
//      * the floor is the max of the warps' maxima, which every warp writes
//        to every block of the cluster through distributed shared memory
//        before one cluster.sync();
//      * the DCT is an FP32 product from shared memory, tiled for the CUDA
//        cores: a lane holds 2 frames x 5 coefficients in registers, and
//        each 16-byte read feeds the 4 or 8 lanes that share it from banks
//        no other read of the instruction uses.  Each coefficient sums its
//        bands in order, one FMA a band, the clamp applied as the operand
//        is read (no TF32, no bf16: ROADMAP's FP32 parity);
//      * the deltas read the block's own MFCC of those rows: the halo is
//        recomputed (12 rows of DCT a block), not fetched from the
//        neighbours, which would put another cluster barrier and a gather
//        from distributed shared memory on a request's chain;
//      * the cluster's warps share the 3C columns; a warp forms a column's
//        mean and centred population std, reading the values of frames
//        other blocks own through distributed shared memory (one more
//        cluster.sync() before, one after).  Every sum runs in the order of
//        the one-block kernel this launch replaced (the DCT band by band;
//        per column, lane l over frames l, l + 32, ..., then the warp's xor
//        tree), so the stats are bit for bit that kernel's at any cluster
//        size: a redesign for speed changes no feature, cache or trained
//        model downstream.  No float atomics: two launches give the same
//        bits.
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
// 3 s) does not fit one SM's shared memory, hence frame tiles and the mel
// written for launch 2.  The tail is bound by its reads (the counts and 5
// bytes a candidate) and, at a request, by its latency: one block per clip,
// a handful of block-wide barriers a pass.
//
// The candidate arithmetic uses __f*_rn intrinsics, which the compiler never
// fuses into FMAs: every operation rounds as the plain PyTorch version's
// separate elementwise ops do, so the tuning bin computed from the kernel's
// own power matches the plain estimate on that power exactly.
#include <cooperative_groups.h>
#include <stdint.h>

#include <algorithm>

#include "rfft_smem.cuh"

using namespace rfft;
namespace cg = cooperative_groups;

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

constexpr int STATS_THREADS = 256;
constexpr int STATS_WARPS = STATS_THREADS / 32;
constexpr int MAX_CLUSTER = 8;  // a portable cluster
constexpr int HALO_BEFORE = 2 * HALF;  // rows before a block's frames its deltas read
constexpr int CHUNK = 20;       // coefficients a warp's DCT tile spans: 4 lanes x 5
constexpr int STATS_COLS = 4;   // columns a warp forms at once for the statistics

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Shared memory of a stats block that owns R frames, as float offsets
// (ops/spectromel.py:stats_smem_bytes mirrors it): 4 floats for the
// mbarrier; every warp's max of every rank [MAX_CLUSTER, 8]; the dB mel rows
// the block transforms [R + 12, M + 4] (its frames, 8 before and 4 after:
// each row padded by 16 bytes, so the rows a read instruction touches sit in
// different banks; after the DCT the same bytes hold the deltas [2, R, C]);
// the DCT table [CC, M + 4] (coefficient-major, CC = C rounded up to 20, zero
// past C, rows padded like the mel's); those rows' MFCC [R + 12, C].
struct StatsLayout {
  int wmax, rows, dct, mf, total;
};

__host__ __device__ inline StatsLayout stats_layout(int R, int M, int C) {
  const int W = R + 3 * HALF, CC = (C + CHUNK - 1) / CHUNK * CHUNK;
  StatsLayout L;
  L.wmax = 4;
  L.rows = L.wmax + MAX_CLUSTER * STATS_WARPS;
  L.dct = L.rows + round4(W * (M + 4) > 2 * R * C ? W * (M + 4) : 2 * R * C);
  L.mf = L.dct + CC * (M + 4);
  L.total = L.mf + round4(W * C);
  return L;
}

__device__ inline uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ inline void mbar_wait(uint32_t bar, uint32_t phase) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(phase) : "memory");
  } while (!done);
}

__device__ inline void bulk_copy(void* dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// The two halves of cluster.sync(): a block arrives as it starts and waits
// just before its first write to another block's shared memory, which is
// safe once every block of the cluster has started.
__device__ inline void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ inline void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ inline float4 clamp4(float4 a, float lo) {
  return make_float4(fmaxf(a.x, lo), fmaxf(a.y, lo), fmaxf(a.z, lo), fmaxf(a.w, lo));
}

// The MFCC [n, C] of n dB mel rows (stride S), clamped at floor_db as they
// are read, against the DCT [CC, S], tiled for the CUDA cores: a warp forms
// 16 frames x 20 coefficients at a time, lane (rl, cg) frames rl and rl + 8
// of the tile x coefficients 5 cg .. 5 cg + 4 in registers.  A 16-byte
// read of 4 bands feeds the 4 lanes of a mel row or the 8 lanes of a DCT
// row, and the 8 mel rows or 4 DCT rows a read instruction touches sit in
// different banks (rows 33 float4s apart).  Each coefficient sums over the
// bands in order from 0, one FMA a band: the one-block kernel's order, so
// the MFCC keeps its bits.
__device__ inline void dct_tiles(const float* rows, const float* dctp, int S, int M, int C,
                                 int n, float floor_db, float* mf) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, rl = lane >> 2, cg = lane & 3;
  const int tiles = (n + 15) / 16, chunks = (C + CHUNK - 1) / CHUNK;
  for (int item = warp; item < tiles * chunks; item += STATS_WARPS) {
    const int t0 = item / chunks * 16, c0 = (item % chunks) * CHUNK + 5 * cg;
    const int r0 = t0 + rl, r1 = r0 + 8;
    const float* x0 = rows + min(r0, n - 1) * S;
    const float* x1 = rows + min(r1, n - 1) * S;
    const float* w = dctp + c0 * S;
    float acc0[5], acc1[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) acc0[i] = acc1[i] = 0.f;
#pragma unroll 2
    for (int j = 0; j < M; j += 4) {
      const float4 a0 = clamp4(*reinterpret_cast<const float4*>(x0 + j), floor_db);
      const float4 a1 = clamp4(*reinterpret_cast<const float4*>(x1 + j), floor_db);
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const float4 d = *reinterpret_cast<const float4*>(w + i * S + j);
        acc0[i] = fmaf(a0.w, d.w, fmaf(a0.z, d.z, fmaf(a0.y, d.y, fmaf(a0.x, d.x, acc0[i]))));
        acc1[i] = fmaf(a1.w, d.w, fmaf(a1.z, d.z, fmaf(a1.y, d.y, fmaf(a1.x, d.x, acc1[i]))));
      }
    }
#pragma unroll
    for (int i = 0; i < 5; ++i)
      if (c0 + i < C) {
        if (r0 < n) mf[r0 * C + c0 + i] = acc0[i];
        if (r1 < n) mf[r1 * C + c0 + i] = acc1[i];
      }
  }
}

// Valid frame t's MFCC row (pm) and delta row (pd; the delta-delta's is R C
// further) in the block of the cluster that owns t: its MFCC window starts
// at lo_q = max(0, q R - 8), its deltas at q R.
__device__ inline void stats_rows(cg::cluster_group& cluster, const float* mf, const float* rows,
                                  int R, int C, int t, const float*& pm, const float*& pd) {
  const int q = t / R;
  pm = mf + (t - max(0, q * R - HALO_BEFORE)) * C;
  pd = rows + (t - q * R) * C;
  if (q != (int)cluster.block_rank()) {
    pm = cluster.map_shared_rank(pm, q);
    pd = cluster.map_shared_rank(pd, q);
  }
}

// grid (cs, B), cluster (cs, 1, 1): blockIdx.y is the clip.  Block rank q
// owns frames [f0, f0 + R), f0 = q R, of the clip's valid ones and forms
// their deltas and partial sums.  It transforms the rows [lo, hi) those
// deltas read -- its valid frames, the 8 before (the interior's halo of 4,
// and a last-edge window that starts up to 8 frames back) and the 4 after,
// rows 0-8 for the first edge, and for a clip of fewer than 9 frames the
// masked frames up to 9 (their dB mel: -100 before the clamp).
__global__ void __launch_bounds__(STATS_THREADS)
    spectromel_stats(const float* __restrict__ mel, const int* __restrict__ lengths, int T,
                     int M, int hop, const float* __restrict__ dct, int C, int R,
                     const float* __restrict__ sg, float* __restrict__ stats) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  cluster_arrive_relaxed();  // this block has started
  const StatsLayout L = stats_layout(R, M, C);
  const int S = M + 4, NC = 3 * C, CC = (C + CHUNK - 1) / CHUNK * CHUNK;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* wmax = smem + L.wmax;  // [rank, warp] maxima
  float* rows = smem + L.rows;  // [hi - lo, S] dB mel; after the DCT d1, d2 [R, C]
  float* dcts = smem + L.dct;   // [CC, S]
  float* mf = smem + L.mf;      // [hi - lo, C]

  const int b = blockIdx.y, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nv = min(1 + lengths[b] / hop, T);
  const int need = min(max(nv, WIDTH), T);
  const int f0 = rank * R;
  const int nvr = max(0, min(R, nv - f0));  // this block's valid frames
  const int lo = max(0, f0 - HALO_BEFORE);
  const int hi = nvr > 0 ? min(need, max(f0 + nvr + HALF, WIDTH)) : lo;
  const uint32_t bar_a = smem_addr(bar);

  // the rows [lo, hi) and the DCT table, bulk copies on one mbarrier
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar_a) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int nld = hi - lo;  // rows this block transforms
  if (warp == 0) {
    const int ncopy = nld;  // rows it copies from device memory
    const uint32_t dct_bytes = (uint32_t)(CC * S * sizeof(float));
    const uint32_t row_bytes = (uint32_t)(M * sizeof(float));
    if (lane == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(bar_a), "r"(dct_bytes + ncopy * row_bytes) : "memory");
      bulk_copy(dcts, dct, dct_bytes, bar_a);
    }
    __syncwarp();
    const float* src = mel + ((size_t)b * T + lo) * M;
    for (int r = lane; r < ncopy; r += 32)
      bulk_copy(rows + r * S, src + (size_t)r * M, row_bytes, bar_a);
  }
  mbar_wait(bar_a, 0);

  // librosa's 80 dB floor under the clip's max over valid frames: each
  // warp's max over the block's own valid frames, written to every block of
  // the cluster through distributed shared memory
  float m = -INFINITY;
  for (int r = warp; r < nvr; r += STATS_WARPS)
    for (int k = 4 * lane; k < M; k += 128) {
      const float4 v = *reinterpret_cast<const float4*>(rows + (f0 - lo + r) * S + k);
      m = fmaxf(m, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
    }
  m = warp_max(m);
  cluster_wait();  // every block has started
  if (lane < cs) cluster.map_shared_rank(wmax, lane)[rank * STATS_WARPS + warp] = m;
  cluster.sync();  // every warp's max is in every block
  float top = -INFINITY;  // every warp reduces the cs x 8 maxima, two a lane
  for (int i = lane; i < cs * STATS_WARPS; i += 32) top = fmaxf(top, wmax[i]);
  const float floor_db = warp_max(top) - 80.0f;

  // the DCT-II of the rows [lo, hi) from shared memory
  dct_tiles(rows, dcts, S, M, C, nld, floor_db, mf);
  __syncthreads();  // the MFCC is in; the mel rows are free

  // SavGol delta and delta-delta of the block's valid frames: 9 taps over
  // 9 consecutive MFCC rows -- the interior centred on t, the first edge
  // rows 0-8, the last edge the clip's own last 9; the interior taps in
  // registers, the edge rows' from the table
  float* d1 = rows;
  float* d2 = d1 + R * C;
  const int start = max(nv - WIDTH, 0);
  float i1[WIDTH], i2[WIDTH];
#pragma unroll
  for (int w = 0; w < WIDTH; ++w) {
    i1[w] = __ldg(sg + w);
    i2[w] = __ldg(sg + SG_ROWS * WIDTH + w);
  }
  for (int i = tid; i < nvr * C; i += STATS_THREADS) {
    const int r = i / C, c = i - r * C, t = f0 + r;
    const int e = t - (nv - HALF);
    float a1 = 0.f, a2 = 0.f;
    if ((e >= 0 && e < HALF) || t < HALF) {  // an edge row
      const bool last = e >= 0 && e < HALF;  // last edge, at this clip's own n_valid
      const int row = last ? 1 + HALF + e : 1 + t;
      const float* v = mf + ((last ? start : 0) - lo) * C + c;
      const float* k1 = sg + row * WIDTH;
      const float* k2 = sg + (SG_ROWS + row) * WIDTH;
#pragma unroll
      for (int w = 0; w < WIDTH; ++w) {
        a1 = fmaf(__ldg(k1 + w), v[w * C], a1);
        a2 = fmaf(__ldg(k2 + w), v[w * C], a2);
      }
    } else {  // interior
      const float* v = mf + (t - HALF - lo) * C + c;
#pragma unroll
      for (int w = 0; w < WIDTH; ++w) {
        a1 = fmaf(i1[w], v[w * C], a1);
        a2 = fmaf(i2[w], v[w * C], a2);
      }
    }
    d1[i] = a1;
    d2[i] = a2;
  }
  __syncthreads();

  cluster.sync();  // every block's MFCC and deltas are in

  // masked mean and population std, centred on the mean, in the one-block
  // kernel's order, so the stats keep their bits: a warp a column (the
  // cluster's warps share the 3C columns, STATS_COLS at a time so that
  // their reads and trees overlap), lane l summing frames l, l + 32, ... in
  // order -- each read from the block that owns it, through distributed
  // shared memory for a neighbour's -- then the warp's xor tree
  const float cnt = (float)max(nv, 1);
  const int nw = cs * STATS_WARPS, gw = rank * STATS_WARPS + warp;
  for (int col0 = gw; col0 < NC; col0 += STATS_COLS * nw) {
    float s[STATS_COLS], mean[STATS_COLS], v[STATS_COLS];
#pragma unroll
    for (int i = 0; i < STATS_COLS; ++i) s[i] = v[i] = 0.f;
    for (int pass = 0; pass < 2; ++pass) {
      for (int t = lane; t < nv; t += 32) {
        const float *pm, *pd;  // frame t's MFCC and delta rows, in the block that owns it
        stats_rows(cluster, mf, rows, R, C, t, pm, pd);
#pragma unroll
        for (int i = 0; i < STATS_COLS; ++i) {
          const int col = col0 + i * nw, k = col / C, c = col - k * C;
          if (col < NC) {
            const float x = k == 0 ? pm[c] : pd[(k - 1) * R * C + c];
            if (pass == 0) {
              s[i] += x;
            } else {
              const float d = x - mean[i];
              v[i] = fmaf(d, d, v[i]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < STATS_COLS; ++i)
        if (pass == 0) mean[i] = warp_sum(s[i]) / cnt;
    }
#pragma unroll
    for (int i = 0; i < STATS_COLS; ++i) {
      const int col = col0 + i * nw, k = col / C, c = col - k * C;
      const float stdv = sqrtf(warp_sum(v[i]) / cnt);
      if (lane == 0 && col < NC) {
        float* out = stats + ((size_t)b * 6 + 2 * k) * C + c;
        out[0] = mean[i];
        out[C] = stdv;
      }
    }
  }
  cluster.sync();  // no block reads another's shared memory any more
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

// Shared memory of a stats block for cs blocks of R frames a clip, or 0 where
// the launch cannot take that geometry.
size_t stats_smem(int T, int M, int C, int cs, int R) {
  if (T < WIDTH || M < 4 || M % 4 != 0 || C < 1 || cs < 1 || cs > MAX_CLUSTER || R < 1 ||
      (long)cs * R < T)
    return 0;
  const size_t bytes = sizeof(float) * (size_t)stats_layout(R, M, C).total;
  return bytes > MAX_SMEM ? 0 : bytes;
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
// bins: [B, T, ceil((hi - lo) / 2)] candidate slots, counts [B, T]; dctT
// [C rounded up to 4, M + 4] (ops/spectromel.py:_device_tables); cs, R: the stats launch's blocks a clip and frames
// a block (ops/spectromel.py:stats_plan).
extern "C" int spectromel_launch(const void* audio, const void* lengths, const void* win,
                                 const void* tw, const void* mel_ranges, const void* mel_w,
                                 const void* rtab, const void* dctT, const void* sg, void* power,
                                 void* mel, void* keys, void* bins, void* counts, void* stats,
                                 void* tb, int B, int N, int n_fft, int hop, int F, int M, int C,
                                 int cs, int R, int lo, int hi, float c_ln2, void* stream) {
  if (hop < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int T = N / hop + 1;
  // the stats launch's geometry is checked before anything is launched
  const size_t smem = stats_smem(T, M, C, cs, R);
  if (smem == 0 || (uintptr_t)mel % 16 != 0 || (uintptr_t)dctT % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_front(audio, lengths, win, tw, mel_ranges, mel_w, rtab, power, mel,
                                 keys, bins, counts, B, N, n_fft, hop, F, M, lo, hi, c_ln2, 1, s);
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(spectromel_stats, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, B);
  cfg.blockDim = dim3(STATS_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, spectromel_stats, (const float*)mel, (const int*)lengths, T, M,
                           hop, (const float*)dctT, C, R, (const float*)sg, (float*)stats);
  if (err != cudaSuccess) return (int)err;
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
